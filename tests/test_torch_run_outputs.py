"""The staged ``consensus`` run's own outputs in the port, against the JAX CLI.

The port's CLI (``--device cpu``) and the JAX CLI (``--backend xla_cpu``)
run on the three committed BAMs; per run:

- ``qc.json`` is equal, whole, the vote plane included (the port's comes
  from the plain version of its QC rider, the JAX one's from its XLA
  rider);
- ``manifest.json`` has the same stages, params and fingerprints, with
  paths relative to the run (the stats sidecars name their backend, so
  they are compared with that key dropped);
- ``run.metrics.json`` has the same keys (the port's adds the run's
  ``counter_marks`` deltas), ``pipeline``, ``bytes_bam_written`` and
  ``intermediate_bam_bytes``.

Then ``--resume``: a second run skips every stage and leaves every BAM's
sha256 as it was, and a changed ``--cutoff`` re-runs every stage from
``sscs``.  ``--intermediate_level 1`` keeps the records equal to the JAX
package's under the same flag.
"""

import hashlib
import json
import os

import pytest

from consensuscruncher_tpu.cli import main as jax_main
from consensuscruncher_tpu_torch.cli import main as torch_main
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.utils.profiling import counter_marks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")
CASES = [("sample.bam", "golden"), ("sample_adversarial.bam", "golden_adv"),
         ("sample_bcerr.bam", "golden_bcerr")]
STAGES = ["dcs", "merge_all_dcs", "merge_all_sscs", "merge_rescued", "singleton_correction",
          "sscs"]


def _argv(bam, name, out, *extra):
    return ["consensus", "-i", os.path.join(DATA, bam), "-o", str(out), "-n", name,
            "--scorrect", "True", "--max_mismatch", "0", *extra]


def _sha256s(base):
    out = {}
    for root, _dirs, files in os.walk(base):
        for f in files:
            if f.endswith(".bam"):
                p = os.path.join(root, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, base)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _manifest(base):
    """Stages -> (params, inputs, outputs) with paths relative to the run's
    output root (``base``'s parent)."""
    root = os.path.dirname(base)
    with open(os.path.join(base, "manifest.json")) as fh:
        stages = json.load(fh)["stages"]
    return {s: (e["params"], {os.path.relpath(p, root): f for p, f in e["inputs"].items()},
                {os.path.relpath(p, root): f for p, f in e["outputs"].items()})
            for s, e in stages.items()}


def _stats_without_backend(path):
    if path.endswith(".json"):
        with open(path) as fh:
            doc = json.load(fh)
    else:
        with open(path) as fh:
            doc = [ln for ln in fh]
        doc = {ln.split(":")[0]: ln for ln in doc}
    return {k: v for k, v in doc.items() if k not in ("backend", "jax_backend")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One port run and one JAX run of each committed BAM."""
    out = tmp_path_factory.mktemp("run_outputs")
    for bam, name in CASES:
        torch_main(_argv(bam, name, out / "torch", "--device", "cpu"))
        jax_main(_argv(bam, name, out / "jax", "--backend", "xla_cpu"))
    return out


@pytest.mark.parametrize("bam,name", CASES)
def test_qc_json_equals_jax(runs, bam, name):
    with open(runs / "torch" / name / "qc.json") as fh:
        got = json.load(fh)
    with open(runs / "jax" / name / "qc.json") as fh:
        want = json.load(fh)
    assert got == want
    assert got["pipeline"] == "staged" and got["plane"]["total_votes"] > 0
    assert got["plane"]["positions"] % 8 == 0


@pytest.mark.parametrize("bam,name", CASES)
def test_manifest_matches_jax(runs, bam, name):
    got = _manifest(str(runs / "torch" / name))
    want = _manifest(str(runs / "jax" / name))
    assert sorted(got) == sorted(want) == STAGES
    for stage in STAGES:
        (g_params, g_in, g_out), (w_params, w_in, w_out) = got[stage], want[stage]
        assert g_params == w_params, stage
        assert sorted(g_in) == sorted(w_in) and sorted(g_out) == sorted(w_out), stage
        for rel, fp in list(g_in.items()) + list(g_out.items()):
            want_fp = w_in.get(rel, w_out.get(rel))
            if "_stats." in rel:  # the sidecar names its backend
                assert fp["size"] > 0 and want_fp["size"] > 0
                assert (_stats_without_backend(str(runs / "torch" / rel))
                        == _stats_without_backend(str(runs / "jax" / rel))), rel
            else:
                assert fp == want_fp, (stage, rel)


@pytest.mark.parametrize("bam,name", CASES)
def test_run_metrics_match_jax(runs, bam, name):
    with open(runs / "torch" / name / "run.metrics.json") as fh:
        got = json.load(fh)
    with open(runs / "jax" / name / "run.metrics.json") as fh:
        want = json.load(fh)
    # the port's document adds the run's counter deltas
    assert sorted(got) == sorted(set(want) | set(counter_marks()))
    for key in ("pipeline", "bytes_bam_written", "intermediate_bam_bytes"):
        assert got[key] == want[key], key
    assert got["pipeline"] == "staged" and got["wall_s"] > 0 and got["bytes_bam_written"] > 0
    assert got["intermediate_bam_bytes"] > 0


def test_resume_skips_intact_stages_and_reruns_changed_params(tmp_path, capsys):
    argv = _argv("sample.bam", "golden", tmp_path, "--device", "cpu")
    torch_main(argv)
    base = str(tmp_path / "golden")
    first = _sha256s(base)
    capsys.readouterr()
    torch_main(argv + ["--resume", "True"])
    out = capsys.readouterr().out
    assert [s for s in STAGES if f"skipping {s} " in out] == STAGES
    assert _sha256s(base) == first
    with open(os.path.join(base, "qc.json")) as fh:
        assert json.load(fh)["plane"] is None  # the skipped SSCS stage voted nothing

    torch_main(argv + ["--resume", "True", "--cutoff", "0.6"])
    out = capsys.readouterr().out
    assert "skipping" not in out  # sscs's params changed; every stage after it re-ran
    assert _manifest(base)["sscs"][0]["cutoff"] == 0.6
    with open(os.path.join(base, "qc.json")) as fh:
        assert json.load(fh)["plane"]["total_votes"] > 0

    # a damaged output makes its stage run again; the re-run restores the
    # same bytes, so the stages after it still find their inputs intact
    second = _sha256s(base)
    with open(os.path.join(base, "dcs", "golden.dcs.sorted.bam"), "ab") as fh:
        fh.write(b"\0")
    torch_main(argv + ["--resume", "True", "--cutoff", "0.6"])
    out = capsys.readouterr().out
    assert [s for s in STAGES if f"skipping {s} " in out] == [s for s in STAGES if s != "dcs"]
    assert _sha256s(base) == second


def test_intermediate_level_keeps_records_equal_to_jax(tmp_path):
    torch_main(_argv("sample.bam", "golden", tmp_path / "torch", "--device", "cpu",
                     "--intermediate_level", "1"))
    jax_main(_argv("sample.bam", "golden", tmp_path / "jax", "--backend", "xla_cpu",
                   "--intermediate_level", "1"))
    got, want = _sha256s(str(tmp_path / "torch" / "golden")), _sha256s(
        str(tmp_path / "jax" / "golden"))
    assert sorted(got) == sorted(want) and len(got) == 11
    for rel in got:
        assert (_records(str(tmp_path / "torch" / "golden" / rel))
                == _records(str(tmp_path / "jax" / "golden" / rel))), rel
    # the per-stage BAMs took level 1, the finals the default level
    default = tmp_path / "default"
    torch_main(_argv("sample.bam", "golden", default, "--device", "cpu"))
    base = _sha256s(str(default / "golden"))
    assert got["sscs/golden.sscs.sorted.bam"] != base["sscs/golden.sscs.sorted.bam"]
    assert (got["all_unique/golden.all.unique.sscs.bam"]
            == base["all_unique/golden.all.unique.sscs.bam"])
