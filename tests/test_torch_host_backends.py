"""``consensus --backend cpu|reference`` of the port against the JAX CLI (CPU).

The JAX package's host backends run in the port as they are: ``cpu`` the
numpy twin (columnar decode, ``consensus_maker_numpy``), ``reference`` the
object path (per-read decode, ``grouping.stream_families``, the Counter
vote); rescue and DCS vote each pair in numpy.  On the same input and
flags, the port's tree equals the JAX CLI's:

- every BAM record by record, tags included; every stats sidecar (the
  JAX one adds ``jax_backend: none``); the manifest's stages, params and
  fingerprints (stats files compared less that key); ``qc.json`` whole
  (no vote plane under a host backend, in either package);
- on ``test/data/sample.bam``, ``sample_bcerr.bam`` and
  ``sample_adversarial.bam``, and on a ~300-fragment ``simulate_bam``
  sample; staged and ``--pipeline streaming``, ``--scorrect False``,
  ``--max_mismatch 1``, ``--host_workers 2``, ``-c`` with ``backend =
  cpu``, a sample batch, and the three stage entries chained.

The JAX refusals come with the JAX text: a non-majority ``--policy``,
``--devices 2``, and an input range under ``reference``.  A host-backend
run opens no CUDA context and builds no kernel; ``--backend cpu`` writes
``--device cpu``'s records (and ``reference`` differs from it only in the
stats key ``backend``); ``--device`` wins; without either the command
still wants the card.
"""

import json
import os
import shutil
import sys

import pytest
import torch

from consensuscruncher_tpu.cli import main as jax_main
from consensuscruncher_tpu.stages import dcs_maker as jax_dcs
from consensuscruncher_tpu.stages import singleton_correction as jax_sc
from consensuscruncher_tpu.stages import sscs_maker as jax_sscs
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.cli import main as torch_main
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.ops import cuda_lib
from consensuscruncher_tpu_torch.stages import dcs_maker, singleton_correction, sscs_maker
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches
from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")
SAMPLE = os.path.join(DATA, "sample.bam")
GOLDEN = json.load(open(os.path.join(REPO, "test", "golden.json")))
sys.path.insert(0, os.path.join(REPO, "test"))
from make_test_data import canonical_bam_digest  # noqa: E402

BACKENDS = ("cpu", "reference")
GOLDENS = [("sample.bam", "consensus", "golden"),
           ("sample_adversarial.bam", "consensus_adversarial", "golden_adv"),
           ("sample_bcerr.bam", "consensus_bcerr_exact", "golden_bcerr")]


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _files(base, suffix):
    return sorted(os.path.relpath(os.path.join(root, f), base)
                  for root, _dirs, files in os.walk(base) for f in files if f.endswith(suffix))


def _stats(path, drop=("jax_backend",)):
    with open(path) as fh:
        if path.endswith(".json"):
            doc = json.load(fh)
        else:
            doc = {ln.split(":")[0]: ln for ln in fh}
    return {k: v for k, v in doc.items() if k not in drop}


def _manifest(base):
    root = os.path.dirname(base)
    with open(os.path.join(base, "manifest.json")) as fh:
        stages = json.load(fh)["stages"]
    return {s: (e["params"], {os.path.relpath(p, root): f for p, f in e["inputs"].items()},
                {os.path.relpath(p, root): f for p, f in e["outputs"].items()})
            for s, e in stages.items()}


def _same_tree(base, jbase, drop=("jax_backend",)) -> int:
    """The port's tree ``base`` equals the JAX tree ``jbase``: BAMs record
    by record, stats sidecars less ``drop``, the manifest, qc.json.
    Returns the number of BAMs held."""
    bams = _files(jbase, ".bam")
    assert _files(base, ".bam") == bams and bams
    for rel in bams:
        assert _records(os.path.join(base, rel)) == _records(os.path.join(jbase, rel)), rel
    stats = [f for f in _files(jbase, "") if "_stats." in f or f.endswith("read_families.txt")]
    assert [f for f in _files(base, "") if "_stats." in f or f.endswith("read_families.txt")] \
        == stats
    for rel in stats:
        assert _stats(os.path.join(base, rel), drop) == _stats(os.path.join(jbase, rel),
                                                                drop), rel
    if os.path.exists(os.path.join(jbase, "manifest.json")):
        got, want = _manifest(base), _manifest(jbase)
        assert sorted(got) == sorted(want)
        for stage in want:
            (g_params, g_in, g_out), (w_params, w_in, w_out) = got[stage], want[stage]
            assert g_params == w_params, stage
            assert sorted(g_in) == sorted(w_in) and sorted(g_out) == sorted(w_out), stage
            for rel, fp in list(g_in.items()) + list(g_out.items()):
                if "_stats." not in rel:  # a stats file's bytes hold jax_backend
                    assert fp == w_in.get(rel, w_out.get(rel)), (stage, rel)
    if os.path.exists(os.path.join(jbase, "qc.json")):
        with open(os.path.join(base, "qc.json")) as fh, \
                open(os.path.join(jbase, "qc.json")) as jfh:
            got_qc, want_qc = json.load(fh), json.load(jfh)
        assert got_qc == want_qc and got_qc["plane"] is None
    return len(bams)


def _argv(bam, name, out, *extra):
    return ["consensus", "-i", bam, "-o", str(out), "-n", name, "--scorrect", "True",
            "--max_mismatch", "0", *extra]


@pytest.fixture
def no_card(monkeypatch):
    """Fail the test if anything opens a CUDA context or builds a kernel."""
    def refuse(*_a, **_k):
        raise AssertionError("a host backend touched the card")

    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    monkeypatch.setattr(cuda_lib, "build", refuse)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sim") / "sim.bam")
    simulate_bam(path, SimConfig(n_fragments=300, seed=13, ref_len=200_000))
    return path


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("bam,section,name", GOLDENS)
def test_trees_equal_jax_on_the_goldens(tmp_path, no_card, backend, bam, section, name):
    argv = _argv(os.path.join(DATA, bam), name, tmp_path / "port", "--backend", backend)
    result = torch_main(argv)
    assert result["pipeline"] == "staged"
    base = str(tmp_path / "port" / name)
    assert golden_mismatches(base, GOLDEN[section]) == []
    jax_main(_argv(os.path.join(DATA, bam), name, tmp_path / "jax", "--backend", backend))
    assert _same_tree(base, str(tmp_path / "jax" / name)) == 11
    assert _stats(os.path.join(base, "dcs", f"{name}.dcs_stats.json"))["backend"] == backend


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("extra", [[], ["--pipeline", "streaming"], ["--scorrect", "False"],
                                   ["--max_mismatch", "1"]],
                         ids=["staged", "streaming", "no_scorrect", "mm1"])
def test_trees_equal_jax_on_a_simulated_sample(tmp_path, no_card, sim, backend, extra):
    torch_main(_argv(sim, "s", tmp_path / "port", "--backend", backend, *extra))
    jax_main(_argv(sim, "s", tmp_path / "jax", "--backend", backend, *extra))
    assert _same_tree(str(tmp_path / "port" / "s"), str(tmp_path / "jax" / "s")) >= 7
    with open(tmp_path / "port" / "s" / "sscs" / "s.sscs_stats.json") as fh:
        stats = json.load(fh)
    assert stats["backend"] == backend and stats["sscs_written"] > 100


def test_config_backend_key_and_the_batch(tmp_path, no_card, sim):
    shutil.copy(sim, tmp_path / "b.bam")
    cfg = tmp_path / "c.ini"
    cfg.write_text("[consensus]\nbackend = cpu\nscorrect = True\n")
    inputs = f"{SAMPLE},{tmp_path / 'b.bam'}"
    got = torch_main(["consensus", "-c", str(cfg), "-i", inputs, "-o", str(tmp_path / "port")])
    assert sorted(got) == sorted(inputs.split(","))
    jax_main(["consensus", "-c", str(cfg), "-i", inputs, "-o", str(tmp_path / "jax")])
    for stem in ("sample", "b"):
        assert _same_tree(str(tmp_path / "port" / stem), str(tmp_path / "jax" / stem)) == 11


@pytest.mark.parametrize("backend", BACKENDS)
def test_host_workers_pass_the_host_backend_on(tmp_path, backend):
    bam = str(tmp_path / "adv.bam")
    shutil.copy(os.path.join(DATA, "sample_adversarial.bam"), bam)
    if backend == "reference":
        # a worker reads a BAI range, which the object path cannot: the
        # worker refuses, as the JAX worker does, and so does the run
        with pytest.raises(SystemExit, match="input_range requires a columnar backend"):
            torch_main(_argv(bam, "a", tmp_path / "port", "--backend", backend,
                             "--host_workers", "2"))
        with pytest.raises(ValueError, match="input_range requires a columnar backend"):
            sscs_maker.run_sscs(bam, str(tmp_path / "x"), None, backend="reference",
                                input_range=object())
        return
    args = torch_cli.parse_args(_argv(bam, "a", tmp_path, "--backend", backend))
    argv = torch_cli.hostshard.worker_argv(bam, str(tmp_path), "r0", args)
    assert argv[argv.index("--backend") + 1] == backend and "--device" not in argv
    torch_main(_argv(bam, "a", tmp_path / "port", "--backend", backend, "--host_workers", "2"))
    torch_main(_argv(bam, "a", tmp_path / "one", "--backend", backend))
    jax_main(_argv(bam, "a", tmp_path / "jax", "--backend", backend, "--host_workers", "2"))
    base, one, jbase = (str(tmp_path / t / "a") for t in ("port", "one", "jax"))
    bams = _files(one, ".bam")
    assert _files(base, ".bam") == bams and len(bams) == 11
    for rel in bams:
        assert _records(os.path.join(base, rel)) == _records(os.path.join(one, rel)), rel
        assert (canonical_bam_digest(os.path.join(base, rel))
                == canonical_bam_digest(os.path.join(jbase, rel))), rel
    for rel in ("sscs/a.sscs_stats.txt", "singleton/a.singleton_stats.txt",
                "dcs/a.dcs_stats.txt"):
        assert _stats(os.path.join(base, rel), ("backend", "jax_backend")) == _stats(
            os.path.join(jbase, rel), ("backend", "jax_backend")), rel
    assert not os.path.exists(os.path.join(base, ".ranges"))


def test_resume_skips_every_stage(tmp_path, no_card, capsys):
    argv = _argv(SAMPLE, "g", tmp_path, "--backend", "reference")
    torch_main(argv)
    capsys.readouterr()
    torch_main(argv + ["--resume", "True"])
    out = capsys.readouterr().out
    assert out.count("skipping ") == 6


def test_stage_entries_chained_equal_jax(tmp_path, no_card):
    roots = {"port": (sscs_maker, singleton_correction, dcs_maker),
             "jax": (jax_sscs, jax_sc, jax_dcs)}
    for tag, (sscs, sc, dcs) in roots.items():
        d = tmp_path / tag
        d.mkdir()
        sscs.main(["--infile", SAMPLE, "--outfile", str(d / "g"), "--backend", "cpu"])
        sc.main(["--singleton", str(d / "g.singleton.sorted.bam"),
                 "--bamfile", str(d / "g.sscs.sorted.bam"), "--outfile", str(d / "r"),
                 "--max-mismatch", "1", "--backend", "cpu"])
        dcs.main(["--infile", str(d / "g.sscs.sorted.bam"), "--outfile", str(d / "d"),
                  "--backend", "cpu"])
    assert _same_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == 8


def _refusal(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("extra", [["--policy", "delegation"], ["--devices", "2"]],
                         ids=["policy", "devices"])
def test_refusals_carry_the_jax_text(tmp_path, no_card, backend, extra):
    got = _refusal(lambda: torch_main(_argv(SAMPLE, "g", tmp_path / "port",
                                            "--backend", backend, *extra)))
    want = _refusal(lambda: jax_main(_argv(SAMPLE, "g", tmp_path / "jax",
                                           "--backend", backend, *extra)))
    assert got == want
    assert got in ("vote policy 'delegation' requires the tpu backend",
                   "--devices > 1 requires the tpu backend")
    assert _files(str(tmp_path / "port"), ".bam") == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_cpu_writes_device_cpu_records(tmp_path, no_card, backend):
    torch_main(_argv(SAMPLE, "g", tmp_path / "host", "--backend", backend))
    base, dev = str(tmp_path / "host" / "g"), str(tmp_path / "dev" / "g")
    torch_main(_argv(SAMPLE, "g", tmp_path / "dev", "--device", "cpu"))
    bams = _files(dev, ".bam")
    assert _files(base, ".bam") == bams and len(bams) == 11
    for rel in bams:
        assert _records(os.path.join(base, rel)) == _records(os.path.join(dev, rel)), rel
    for rel in _files(dev, "_stats.json"):
        got, want = _stats(os.path.join(base, rel), ()), _stats(os.path.join(dev, rel), ())
        assert got.pop("backend") == backend and want.pop("backend") == "cpu"
        assert got == want, rel


def test_device_wins_and_the_card_stays_the_default(tmp_path, monkeypatch):
    argv = _argv(SAMPLE, "g", tmp_path, "--backend", "cpu", "--device", "cuda")
    assert torch_cli.parse_args(argv).host_backend is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flags in (["--backend", "cpu", "--device", "cuda"], [], ["--backend", "tpu"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_main(_argv(SAMPLE, "g", tmp_path, *flags))
    assert _files(str(tmp_path), ".bam") == []


@pytest.mark.parametrize("stage", ["sscs", "singleton_correction", "dcs"])
def test_stages_refuse_an_unknown_backend(tmp_path, stage):
    run = {"sscs": lambda: sscs_maker.run_sscs(SAMPLE, str(tmp_path / "s"), None,
                                               backend="tpu"),
           "singleton_correction": lambda: singleton_correction.run_singleton_correction(
               SAMPLE, SAMPLE, str(tmp_path / "r"), None, backend="tpu"),
           "dcs": lambda: dcs_maker.run_dcs(SAMPLE, str(tmp_path / "d"), None,
                                            backend="tpu")}[stage]
    with pytest.raises(ValueError, match="unknown backend 'tpu'"):
        run()
    assert os.listdir(tmp_path) == []
