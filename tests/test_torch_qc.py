"""The port's QC document (``obs/qc.py``) against the JAX package's.

Same inputs through both modules, equal results: the accumulator's padding
of vectors of different lengths, deferred handles (torch tensors in the
port, arrays in the JAX package), ``collect_run`` over a run's stage
sidecars, ``merge_docs``, the bytes ``write_qc`` commits, ``read_qc``,
``spectrum_distance`` and the report and diff text.  Every comparison is
exact.
"""

import os

import numpy as np
import pytest
import torch

from consensuscruncher_tpu.obs import qc as jqc
from consensuscruncher_tpu_torch.cli import main as torch_main
from consensuscruncher_tpu_torch.obs import qc as tqc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vectors(seed):
    """Vote/disagree vector pairs of several lengths (as batches of
    different longest families give), trailing zeros included."""
    rng = np.random.default_rng(seed)
    out = []
    for length in (104, 96, 112, 8, 112):
        votes = rng.integers(0, 500, length).astype(np.int32)
        votes[-3:] = 0
        out.append((votes, (votes * rng.random(length) * 0.1).astype(np.int32)))
    return out


@pytest.mark.parametrize("deferred", [False, True])
def test_accumulator_matches_jax(deferred):
    t_acc, j_acc = tqc.QcAccumulator("r"), jqc.QcAccumulator("r")
    for votes, disagree in _vectors(1):
        if deferred:  # the port's handles are (2, L) tensors, as the stage hands them
            t_acc.add_plane_handle(torch.from_numpy(np.stack([votes, disagree])))
            j_acc.add_plane_handle((votes, disagree))
        else:
            t_acc.add_plane(votes, disagree)
            j_acc.add_plane(votes, disagree)
    assert t_acc.has_planes and j_acc.has_planes
    doc = t_acc.plane_doc()
    assert doc == j_acc.plane_doc()
    assert doc["positions"] == 112 and doc["votes"][-1] == 0
    assert tqc.QcAccumulator().plane_doc() is None is jqc.QcAccumulator().plane_doc()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A finished port run on the committed sample (its stage sidecars)."""
    out = tmp_path_factory.mktemp("qc_run")
    torch_main(["consensus", "-i", os.path.join(REPO, "test", "data", "sample.bam"),
                "-o", str(out), "-n", "golden", "--device", "cpu"])
    return str(out / "golden")


@pytest.mark.parametrize("with_plane", [False, True])
def test_collect_run_matches_jax(run_dir, with_plane):
    t_acc = j_acc = None
    if with_plane:
        t_acc, j_acc = tqc.QcAccumulator(), jqc.QcAccumulator()
        for votes, disagree in _vectors(2):
            t_acc.add_plane(votes, disagree)
            j_acc.add_plane(votes, disagree)
    got = tqc.collect_run(run_dir, "golden", pipeline="staged", acc=t_acc)
    want = jqc.collect_run(run_dir, "golden", pipeline="staged", acc=j_acc)
    assert got == want
    assert got["sources"] == ["sscs", "singleton_correction", "dcs"]
    assert got["yields"]["families"] > 0 and got["spectrum"]
    assert (got["plane"] is not None) == with_plane
    # a run with nothing on disk yet: keys at 0 / absent, alike
    assert tqc.collect_run(run_dir, "absent") == jqc.collect_run(run_dir, "absent")


def test_merge_write_read_report_diff_match_jax(run_dir, tmp_path):
    docs = []
    for i, vectors in enumerate((_vectors(3), _vectors(4)[:2], None)):
        acc = None
        if vectors is not None:
            acc = jqc.QcAccumulator()
            for votes, disagree in vectors:
                acc.add_plane(votes, disagree)
        doc = jqc.collect_run(run_dir, "golden", pipeline="streaming", acc=acc)
        doc["run"] = f"part{i}"
        docs.append(doc)
    merged = tqc.merge_docs(docs)
    assert merged == jqc.merge_docs(docs)
    assert merged["merged_from"] == 3 and merged["plane"]["positions"] == 112

    tqc.write_qc(str(tmp_path / "t.json"), merged)
    jqc.write_qc(str(tmp_path / "j.json"), merged)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert tqc.read_qc(str(tmp_path / "t.json")) == jqc.read_qc(str(tmp_path / "j.json"))
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".qc.")]  # no temp left

    labelled = [(d["run"], d) for d in docs]
    assert tqc.render_report(labelled) == jqc.render_report(labelled)
    assert tqc.render_report(labelled[:1]) == jqc.render_report(labelled[:1])
    assert (tqc.render_diff(docs[0], docs[2], "a", "b")
            == jqc.render_diff(docs[0], docs[2], "a", "b"))
    skewed = dict(docs[1], spectrum={"1": 10, "2": 5, "9": 1})
    assert (tqc.spectrum_distance(docs[0]["spectrum"], skewed["spectrum"])
            == jqc.spectrum_distance(docs[0]["spectrum"], skewed["spectrum"]))
    assert tqc.render_diff(docs[0], skewed) == jqc.render_diff(docs[0], skewed)


@pytest.mark.parametrize("value", [None, "1", "0", "false", "Off", "yes"])
def test_enabled_reads_cct_qc_as_jax_does(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("CCT_QC", raising=False)
    else:
        monkeypatch.setenv("CCT_QC", value)
    assert tqc.enabled() == jqc.enabled()


def test_plane_sink_arms_and_clears():
    acc = tqc.QcAccumulator()
    tqc.set_plane_sink(acc)
    try:
        assert tqc.plane_sink() is acc
    finally:
        tqc.set_plane_sink(None)
    assert tqc.plane_sink() is None
