"""The rescue and DCS object window walks of the port, against the JAX package.

An aligned sample's reads already carry tags (``NM:i:0`` from every
``bwa mem`` read): its singletons keep them in front of ``XT``/``XF``, so
the block paths of the rescue and DCS stages meet records whose tag block
does not lead with ``XT:Z`` + ``XF:i`` and restart on the window walks.

- the port's CLI (``--device cpu``) on a tagged copy of ``sample.bam``
  writes every BAM and stats sidecar equal to the JAX CLI's
  (``--backend xla_cpu``), record by record, with ``--scorrect True`` and
  ``False``;
- ``run_dcs`` and ``run_singleton_correction`` on hand-built consensus
  BAMs that mix XT-first and tag-first records equal the JAX stages (its
  DCS restart, its rescue walk via ``_force_object``);
- ``--pipeline streaming`` on the tagged input re-runs staged, reports
  ``staged`` and writes the staged tree;
- only ``grouping.ForeignTagLayout`` routes to a walk, and a device error
  inside a walk raises.
"""

import hashlib
import json
import os

import pytest
import torch

from consensuscruncher_tpu.cli import main as jax_main
from consensuscruncher_tpu.stages import dcs_maker as jax_dcs
from consensuscruncher_tpu.stages import singleton_correction as jax_sc
from consensuscruncher_tpu_torch.cli import main as torch_main
from consensuscruncher_tpu_torch.io.bam import BamReader, BamWriter
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.stages import dcs_maker, grouping, singleton_correction

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")
CPU = torch.device("cpu")


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _bams(base):
    return sorted(os.path.relpath(os.path.join(root, f), base)
                  for root, _dirs, files in os.walk(base)
                  for f in files if f.endswith(".bam"))


def _stats(path):
    with open(path) as fh:
        doc = json.load(fh)
    return {k: v for k, v in doc.items() if k not in ("backend", "jax_backend")}


def _tree(base) -> dict:
    out = {}
    for rel in _bams(base):
        with open(os.path.join(base, rel), "rb") as fh:
            out[rel] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _retag(src, dst, every: int = 1):
    """Copy ``src`` with ``NM:i:0`` put in front of the tags of every
    ``every``-th record (the port's own ``BamWriter``)."""
    with BamReader(src) as reader, BamWriter(dst, reader.header) as writer:
        for i, read in enumerate(reader):
            if i % every == 0:
                read.tags = {"NM": ("i", 0), **read.tags}
            writer.write(read)


@pytest.fixture(scope="module")
def tagged(tmp_path_factory):
    td = tmp_path_factory.mktemp("tagged")
    path = str(td / "tagged.bam")
    _retag(SAMPLE, path)
    return path


def _assert_same_run(base, jbase):
    bams = _bams(jbase)
    assert bams == _bams(base) and bams
    for rel in bams:
        assert _records(os.path.join(base, rel)) == _records(os.path.join(jbase, rel)), rel
    for stage, name in (("sscs", "t.sscs_stats.json"), ("dcs", "t.dcs_stats.json"),
                        ("singleton", "t.singleton_stats.json")):
        path = os.path.join(base, stage, name)
        if os.path.exists(os.path.join(jbase, stage, name)):
            assert _stats(path) == _stats(os.path.join(jbase, stage, name)), name


@pytest.fixture(scope="module")
def tagged_runs(tmp_path_factory, tagged):
    """The port's staged run (``--device cpu``) and the JAX CLI's of the
    tagged sample, ``--scorrect True``."""
    td = tmp_path_factory.mktemp("tagged_runs")
    argv = ["consensus", "-i", tagged, "-n", "t", "--scorrect", "True"]
    res = torch_main(argv + ["-o", str(td / "torch"), "--device", "cpu"])
    assert res["pipeline"] == "staged"
    jax_main(argv + ["-o", str(td / "jax"), "--backend", "xla_cpu"])
    return str(td / "torch" / "t"), str(td / "jax" / "t")


def test_tagged_input_matches_jax(tagged_runs):
    base, jbase = tagged_runs
    _assert_same_run(base, jbase)
    with open(os.path.join(base, "singleton", "t.singleton_stats.json")) as fh:
        stats = json.load(fh)
    # every singleton of the tagged sample went through the walk
    assert stats["rescued_by_sscs"] == 254 and stats["rescued_by_singleton"] == 64
    assert len(_records(os.path.join(base, "dcs", "t.dcs.sorted.bam"))) - 1 == 956


def test_tagged_input_without_rescue_matches_jax(tmp_path, tagged):
    argv = ["consensus", "-i", tagged, "-n", "t", "--scorrect", "False"]
    torch_main(argv + ["-o", str(tmp_path / "torch"), "--device", "cpu"])
    jax_main(argv + ["-o", str(tmp_path / "jax"), "--backend", "xla_cpu"])
    _assert_same_run(str(tmp_path / "torch" / "t"), str(tmp_path / "jax" / "t"))


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The port's SSCS-stage outputs of ``sample.bam`` with every third
    record's tag block led by ``NM`` instead of ``XT``."""
    td = tmp_path_factory.mktemp("mixed")
    torch_main(["consensus", "-i", SAMPLE, "-o", str(td / "run"), "-n", "s",
                "--device", "cpu", "--scorrect", "False"])
    out = {}
    for key, rel in (("sscs", "sscs/s.sscs.sorted.bam"),
                     ("singleton", "sscs/s.singleton.sorted.bam")):
        out[key] = str(td / f"{key}.mixed.bam")
        _retag(str(td / "run" / "s" / rel), out[key], every=3)
    return out


def test_dcs_on_mixed_layouts_matches_jax(tmp_path, mixed):
    res = dcs_maker.run_dcs(mixed["sscs"], str(tmp_path / "p"), CPU)
    want = jax_dcs.run_dcs(mixed["sscs"], str(tmp_path / "j"), backend="cpu")
    for got_path, want_path in ((res.dcs_bam, want.dcs_bam),
                                (res.sscs_singleton_bam, want.sscs_singleton_bam)):
        assert _records(got_path) == _records(want_path)
    assert res.stats.get("pairs") == want.stats.get("pairs") > 0
    assert _stats(str(tmp_path / "p.dcs_stats.json")) == _stats(str(tmp_path / "j.dcs_stats.json"))


@pytest.mark.parametrize("max_mismatch", [0, 1])
def test_rescue_on_mixed_layouts_matches_jax_walk(tmp_path, mixed, max_mismatch):
    res = singleton_correction.run_singleton_correction(
        mixed["singleton"], mixed["sscs"], str(tmp_path / "p"), CPU,
        max_mismatch=max_mismatch)
    want = jax_sc.run_singleton_correction(
        mixed["singleton"], mixed["sscs"], str(tmp_path / "j"), max_mismatch=max_mismatch,
        backend="cpu", _force_object=True)
    for attr in ("sscs_rescue_bam", "singleton_rescue_bam", "remaining_bam"):
        assert _records(getattr(res, attr)) == _records(getattr(want, attr)), attr
    assert res.stats.get("rescued_by_sscs") == want.stats.get("rescued_by_sscs") > 0
    assert res.stats.get("max_mismatch") == max_mismatch
    assert (_stats(str(tmp_path / "p.singleton_stats.json"))
            == _stats(str(tmp_path / "j.singleton_stats.json")))


def test_streaming_on_tagged_input_reruns_staged(tmp_path, tagged, tagged_runs):
    res = torch_main(["consensus", "-i", tagged, "-n", "t", "--device", "cpu",
                      "-o", str(tmp_path), "--pipeline", "streaming"])
    assert res["pipeline"] == "staged"
    got, want = _tree(str(tmp_path / "t")), _tree(tagged_runs[0])
    assert got == want and len(got) == 11
    with open(tmp_path / "t" / "run.metrics.json") as fh:
        assert json.load(fh)["pipeline"] == "staged"


def test_block_paths_raise_the_typed_exception(tagged):
    with ColumnarReader(tagged) as reader:
        batch = next(reader.batches())
        with pytest.raises(grouping.ForeignTagLayout):
            grouping._rescue_src_prep(batch)
    with ColumnarReader(tagged) as reader:
        with pytest.raises(grouping.ForeignTagLayout):
            next(grouping.duplex_pair_blocks(reader, reader.header))


def test_only_the_typed_exception_routes_to_the_walk(tmp_path, mixed, monkeypatch):
    """A ``ValueError`` that merely says "foreign tag layout" is a fault of
    the program, not a layout the walks take: it raises."""
    def fault(*a, **k):
        raise ValueError("foreign tag layout (no XT/XF prefix)")

    def no_walk(*a, **k):
        raise AssertionError("walk entered")

    monkeypatch.setattr(dcs_maker, "_consume_pair_blocks", fault)
    monkeypatch.setattr(dcs_maker, "_run_dcs_windows", no_walk)
    with pytest.raises(ValueError, match="foreign tag layout"):
        dcs_maker.run_dcs(mixed["sscs"], str(tmp_path / "d"), CPU)
    monkeypatch.setattr(singleton_correction, "_run_rescue_blocks", fault)
    monkeypatch.setattr(singleton_correction, "_run_rescue_walk", no_walk)
    with pytest.raises(ValueError, match="foreign tag layout"):
        singleton_correction.run_singleton_correction(
            mixed["singleton"], mixed["sscs"], str(tmp_path / "r"), CPU)
    assert not os.path.exists(tmp_path / "d.dcs.sorted.bam")
    assert not os.path.exists(tmp_path / "r.remaining.singleton.sorted.bam")


def _device_fault(*a, **k):
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


@pytest.mark.parametrize("stage", ["dcs", "rescue"])
def test_device_error_inside_a_walk_raises(tmp_path, mixed, monkeypatch, stage):
    mod = dcs_maker if stage == "dcs" else singleton_correction
    monkeypatch.setattr(mod, "_duplex_vote_batch", _device_fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        if stage == "dcs":
            dcs_maker.run_dcs(mixed["sscs"], str(tmp_path / "d"), CPU)
        else:
            singleton_correction.run_singleton_correction(
                mixed["singleton"], mixed["sscs"], str(tmp_path / "r"), CPU)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".bam")]


def test_device_error_in_the_walk_does_not_rerun_staged(tmp_path, tagged, monkeypatch):
    """Streaming re-runs staged on the tagged input; the staged rescue walk
    then meets the device fault, which raises."""
    monkeypatch.setattr(singleton_correction, "_duplex_vote_batch", _device_fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        torch_main(["consensus", "-i", tagged, "-n", "t", "--device", "cpu",
                    "-o", str(tmp_path), "--pipeline", "streaming"])
