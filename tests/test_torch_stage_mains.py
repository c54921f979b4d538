"""The standalone stage entries of the port against the JAX package's.

The reference runs each stage script on its own; so do both packages
(``python -m <package>.stages.<stage>``).  On ``test/data/sample.bam``
each voting entry of the port with ``--device cpu`` writes every BAM
record by record, tags included, and every stats file less its backend
lines, equal to the JAX entry's (its default ``--backend tpu``, on JAX's
CPU platform under ``JAX_PLATFORMS=cpu``): ``sscs_maker``, then
``singleton_correction`` (``--max-mismatch`` 0 and 1), then
``dcs_maker`` on the SSCS BAM.  The
SSCS and rescue outputs also equal the ``consensus`` goldens of
``test/golden.json``.  The entries read the reference's ``--backend``
as the device: ``tpu`` (the default) is the card, and raises without
CUDA; ``cpu`` runs the JAX entry's numpy host path, touching no card, and
writes the JAX entry's outputs; ``--device`` wins.
``generate_plots.main`` writes the reference's file names.
"""

import json
import os

import pytest
import torch

from consensuscruncher_tpu.stages import dcs_maker as jax_dcs
from consensuscruncher_tpu.stages import generate_plots as jax_plots
from consensuscruncher_tpu.stages import singleton_correction as jax_sc
from consensuscruncher_tpu.stages import sscs_maker as jax_sscs
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.stages import dcs_maker, generate_plots, singleton_correction
from consensuscruncher_tpu_torch.stages import sscs_maker
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _no_backend(path):
    with open(path) as fh:
        if path.endswith(".json"):
            return {k: v for k, v in json.load(fh).items() if k not in ("backend", "jax_backend")}
        return [ln for ln in fh if "backend" not in ln]


def _same_outputs(port_dir, jax_dir, stem) -> int:
    """Every BAM, stats file and family table of prefix ``stem``: records
    and lines equal.  Returns the number of BAMs held."""
    names = sorted(f for f in os.listdir(jax_dir) if f.startswith(stem + "."))
    assert sorted(f for f in os.listdir(port_dir) if f.startswith(stem + ".")) == names
    bams = 0
    for f in names:
        port, jax = os.path.join(port_dir, f), os.path.join(jax_dir, f)
        if f.endswith(".bam"):
            assert _records(port) == _records(jax), f
            bams += 1
        elif "_stats." in f or f.endswith("read_families.txt"):
            assert _no_backend(port) == _no_backend(jax), f
    return bams


@pytest.fixture(scope="module")
def sscs_runs(tmp_path_factory):
    """``sscs_maker.main`` of both packages on ``sample.bam``, each under
    ``<root>/sscs/golden`` (the consensus goldens' naming)."""
    roots = {}
    for tag, mod, extra in (("port", sscs_maker, ["--device", "cpu"]), ("jax", jax_sscs, [])):
        roots[tag] = tmp_path_factory.mktemp(tag)
        os.makedirs(roots[tag] / "sscs")
        mod.main(["--infile", SAMPLE, "--outfile", str(roots[tag] / "sscs" / "golden"), *extra])
    return roots


def _golden_section(prefix: str) -> dict:
    with open(os.path.join(REPO, "test", "golden.json")) as fh:
        return {k: v for k, v in json.load(fh)["consensus"].items() if k.startswith(prefix)}


def test_sscs_entry_equals_jax_and_the_goldens(sscs_runs):
    assert _same_outputs(sscs_runs["port"] / "sscs", sscs_runs["jax"] / "sscs", "golden") == 3
    golden = _golden_section("sscs/")
    assert len(golden) == 6
    assert golden_mismatches(str(sscs_runs["port"]), golden) == []


@pytest.mark.parametrize("mm", [0, 1])
def test_singleton_entry_equals_jax(sscs_runs, mm):
    for tag, mod, extra in (("port", singleton_correction, ["--device", "cpu"]),
                            ("jax", jax_sc, [])):
        root = sscs_runs[tag]
        os.makedirs(root / f"singleton{mm}", exist_ok=True)
        mod.main(["--singleton", str(root / "sscs" / "golden.singleton.sorted.bam"),
                  "--bamfile", str(root / "sscs" / "golden.sscs.sorted.bam"),
                  "--outfile", str(root / f"singleton{mm}" / "golden"),
                  "--max-mismatch", str(mm), *extra])
    port, jax = (sscs_runs[t] / f"singleton{mm}" for t in ("port", "jax"))
    assert _same_outputs(port, jax, "golden") == 3
    with open(port / "golden.singleton_stats.json") as fh:
        assert json.load(fh)["max_mismatch"] == mm
    if mm == 0:  # the consensus run's rescue is this entry's
        os.rename(port, sscs_runs["port"] / "singleton")
        golden = _golden_section("singleton/")
        assert len(golden) == 5
        assert golden_mismatches(str(sscs_runs["port"]), golden) == []


def test_dcs_entry_equals_jax(sscs_runs):
    for tag, mod, extra in (("port", dcs_maker, ["--device", "cpu"]), ("jax", jax_dcs, [])):
        root = sscs_runs[tag]
        os.makedirs(root / "dcs", exist_ok=True)
        mod.main(["--infile", str(root / "sscs" / "golden.sscs.sorted.bam"),
                  "--outfile", str(root / "dcs" / "golden"), *extra])
    port = sscs_runs["port"] / "dcs"
    assert _same_outputs(port, sscs_runs["jax"] / "dcs", "golden") == 2
    with open(port / "golden.dcs_stats.json") as fh:
        assert json.load(fh)["pairs"] > 0


def _entry_argv(entry, tmp_path):
    bam = str(tmp_path / "none.bam")
    return {
        "sscs_maker": (sscs_maker, ["--infile", SAMPLE, "--outfile", str(tmp_path / "x")]),
        "singleton_correction": (singleton_correction, [
            "--singleton", bam, "--bamfile", bam, "--outfile", str(tmp_path / "y")]),
        "dcs_maker": (dcs_maker, ["--infile", bam, "--outfile", str(tmp_path / "z")]),
    }[entry]


ENTRIES = ("sscs_maker", "singleton_correction", "dcs_maker")


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("flags", [[], ["--backend", "tpu"], ["--device", "cuda"],
                                   ["--backend", "cpu", "--device", "cuda"]])
def test_entries_default_to_the_card_and_raise_without_it(monkeypatch, tmp_path, entry, flags):
    mod, argv = _entry_argv(entry, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        mod.main([*argv, *flags])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("entry", ENTRIES)
def test_backend_cpu_exits_naming_device(monkeypatch, sscs_runs, tmp_path, entry):
    """``--backend cpu`` without ``--device`` runs the entry's host backend
    (the JAX entry's numpy path): it opens no CUDA context and builds no
    kernel, and writes the JAX entry's outputs under the same flag, its
    stats recording ``backend: cpu``."""
    from consensuscruncher_tpu_torch.ops import cuda_lib

    def no_card(*_a, **_k):
        raise AssertionError("a host backend touched the card")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_card)
    monkeypatch.setattr(cuda_lib, "build", no_card)
    src = sscs_runs["jax"] / "sscs"
    mod, jax_mod, argv, stats = {
        "sscs_maker": (sscs_maker, jax_sscs, ["--infile", SAMPLE], "sscs_stats"),
        "singleton_correction": (singleton_correction, jax_sc, [
            "--singleton", str(src / "golden.singleton.sorted.bam"),
            "--bamfile", str(src / "golden.sscs.sorted.bam")], "singleton_stats"),
        "dcs_maker": (dcs_maker, jax_dcs, ["--infile", str(src / "golden.sscs.sorted.bam")],
                      "dcs_stats"),
    }[entry]
    for tag, m in (("port", mod), ("jax", jax_mod)):
        os.makedirs(tmp_path / tag)
        m.main([*argv, "--outfile", str(tmp_path / tag / "golden"), "--backend", "cpu"])
    assert _same_outputs(tmp_path / "port", tmp_path / "jax", "golden") >= 2
    with open(tmp_path / "port" / f"golden.{stats}.json") as fh:
        assert json.load(fh)["backend"] == "cpu"


def test_device_wins_over_backend(tmp_path):
    sscs_maker.main(["--infile", SAMPLE, "--outfile", str(tmp_path / "a"),
                     "--backend", "cpu", "--device", "cpu"])
    sscs_maker.main(["--infile", SAMPLE, "--outfile", str(tmp_path / "b"),
                     "--backend", "tpu", "--device", "cpu"])
    assert _same_outputs(tmp_path, tmp_path, "a") == 3
    assert _records(str(tmp_path / "a.sscs.sorted.bam")) == \
        _records(str(tmp_path / "b.sscs.sorted.bam"))
    with open(tmp_path / "a.sscs_stats.json") as fh:
        assert json.load(fh)["backend"] == "cpu"


def test_generate_plots_writes_the_reference_files(sscs_runs, tmp_path):
    from consensuscruncher_tpu_torch.utils.stats import FamilySizeHistogram, StageStats

    hist = FamilySizeHistogram()
    for s in (1, 1, 2, 3, 3, 3, 8):
        hist.add(s)
    hist.write(str(tmp_path / "fams.txt"))
    st = StageStats("SSCS")
    st.incr("sscs_written", 10)
    st.incr("singletons", 4)
    st.write(str(tmp_path / "sscs_stats.txt"))
    metrics = tmp_path / "x.metrics.json"
    metrics.write_text(json.dumps({"stage": "SSCS", "phases_s": {"consensus": 3.2, "sort": 0.7},
                                   "n_reads": 100}))
    run = sscs_runs["port"] / "sscs"
    cases = {
        "synthetic": ["--families", str(tmp_path / "fams.txt"),
                      "--stats", str(tmp_path / "sscs_stats.json"),
                      "--metrics", str(metrics), str(tmp_path / "missing.metrics.json")],
        "run": ["--families", str(run / "golden.read_families.txt"),
                "--stats", str(run / "golden.sscs_stats.json"),
                "--metrics", str(run / "golden.metrics.json")],
        "families_only": ["--families", str(tmp_path / "fams.txt")],
    }
    for case, argv in cases.items():
        written = {}
        for tag, mod in (("port", generate_plots), ("jax", jax_plots)):
            out = tmp_path / case / tag
            mod.main([*argv, "--outdir", str(out)])
            written[tag] = sorted(os.listdir(out))
        assert written["port"] == written["jax"], case
        for name in written["port"]:
            with open(tmp_path / case / "port" / name, "rb") as fh:
                assert generate_plots.decode_png(fh.read()).shape[2] == 3
    assert written["port"] == ["family_size.png"]
    assert sorted(os.listdir(tmp_path / "synthetic" / "port")) == [
        "family_size.png", "read_recovery.png", "stage_times.png"]
