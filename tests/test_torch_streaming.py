"""``--pipeline streaming`` in the port, against its staged pipeline and the
JAX package's streaming run (the port's counterpart of
``tests/test_streaming_parity.py``), on the CPU.

- taps on: every BAM and index of the tree is byte-identical to staged;
- taps off: the finals are byte-identical and no intermediate exists
  (``run.metrics.json`` counts 0 intermediate bytes);
- the records equal the JAX CLI's streaming run's (``--backend xla_cpu``);
- ``qc.json``'s vote plane equals the staged run's;
- a host-side condition streaming cannot get past (a sort buffer that
  spills, a failed background write) re-runs the staged pipeline, whose
  outputs are those of a staged run; a device error raises instead.
"""

import hashlib
import json
import os

import pytest

from consensuscruncher_tpu.cli import main as jax_main
from consensuscruncher_tpu_torch.cli import main as torch_main
from consensuscruncher_tpu_torch.io import columnar
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.ops import consensus_segment
from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_bam_fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "s"
# the stage-boundary files streaming writes only as taps (the unpaired-SSCS
# final dcs/s.sscs.singleton.sorted.bam is not one of them)
INTERMEDIATES = (f"sscs/{NAME}.singleton.sorted.bam",
                 f"singleton/{NAME}.sscs.rescue.sorted.bam",
                 f"singleton/{NAME}.singleton.rescue.sorted.bam",
                 f"dcs/{NAME}.sscs.rescued.bam")


def _tree(base) -> dict:
    """relpath -> sha256 of every .bam and .bai under ``base``."""
    out = {}
    for root, _dirs, files in os.walk(base):
        for f in files:
            if f.endswith((".bam", ".bai")):
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


def _run(bam, out, *extra) -> dict:
    res = torch_main(["consensus", "-i", str(bam), "-o", str(out), "-n", NAME,
                      "--device", "cpu", *extra])
    with open(os.path.join(str(out), NAME, "run.metrics.json")) as fh:
        metrics = json.load(fh)
    assert metrics["pipeline"] == res["pipeline"]
    return metrics


@pytest.fixture(scope="module", params=["sample", "simulated"])
def staged(request, tmp_path_factory):
    """An input and the port's staged run of it."""
    td = tmp_path_factory.mktemp(f"stream_{request.param}")
    if request.param == "sample":
        bam = os.path.join(REPO, "test", "data", "sample.bam")
    else:
        bam = str(td / "in.bam")
        simulate_bam_fast(bam, SimConfig(n_fragments=400, ref_len=30_000, seed=5))
    metrics = _run(bam, td / "staged")
    assert metrics["intermediate_bam_bytes"] > 0
    return {"bam": bam, "base": td / "staged" / NAME}


def test_streaming_with_taps_is_byte_identical(staged, tmp_path):
    m = _run(staged["bam"], tmp_path, "--pipeline", "streaming", "--intermediate_taps", "True")
    assert m["pipeline"] == "streaming"
    ref = _tree(staged["base"])
    assert len(ref) == 21 and _tree(tmp_path / NAME) == ref


def test_streaming_without_taps_finals_identical_no_intermediates(staged, tmp_path):
    m = _run(staged["bam"], tmp_path, "--pipeline", "streaming")
    assert m["pipeline"] == "streaming" and m["intermediate_bam_bytes"] == 0
    ref = _tree(staged["base"])
    got = _tree(tmp_path / NAME)
    skipped = {r for r in ref if r.startswith(INTERMEDIATES)}
    assert len(skipped) == 8
    assert got == {r: h for r, h in ref.items() if r not in skipped}
    with open(tmp_path / NAME / "manifest.json") as fh:
        assert list(json.load(fh)["stages"]) == ["consensus_stream"]
    with open(tmp_path / NAME / "qc.json") as fh:
        qc = json.load(fh)
    with open(staged["base"] / "qc.json") as fh:
        staged_qc = json.load(fh)
    assert qc["pipeline"] == "streaming" and qc["plane"]["total_votes"] > 0
    assert qc["plane"] == staged_qc["plane"]
    assert {k: v for k, v in qc.items() if k != "pipeline"} == \
        {k: v for k, v in staged_qc.items() if k != "pipeline"}


def test_streaming_records_equal_jax_streaming(staged, tmp_path):
    for pkg, main, extra in (("torch", torch_main, ["--device", "cpu"]),
                             ("jax", jax_main, ["--backend", "xla_cpu"])):
        main(["consensus", "-i", str(staged["bam"]), "-o", str(tmp_path / pkg), "-n", NAME,
              "--pipeline", "streaming", "--intermediate_taps", "True", *extra])
    got = sorted(r for r in _tree(tmp_path / "torch" / NAME) if r.endswith(".bam"))
    assert got == sorted(r for r in _tree(tmp_path / "jax" / NAME) if r.endswith(".bam"))
    assert len(got) == 11
    for rel in got:
        assert (_records(str(tmp_path / "torch" / NAME / rel))
                == _records(str(tmp_path / "jax" / NAME / rel))), rel
    with open(tmp_path / "torch" / NAME / "qc.json") as fh:
        got_qc = json.load(fh)
    with open(tmp_path / "jax" / NAME / "qc.json") as fh:
        assert got_qc == json.load(fh)


def test_sort_buffer_spill_falls_back_to_staged(tmp_path, monkeypatch, capsys):
    bam = os.path.join(REPO, "test", "data", "sample.bam")
    # a sort buffer far below the sample's records: every sorting writer
    # spills, and no in-memory hand-off exists past a spill
    monkeypatch.setattr(columnar, "_default_sort_buffer_bytes", lambda: 4096)
    m = _run(bam, tmp_path / "stream", "--pipeline", "streaming")
    assert m["pipeline"] == "staged"  # what the run actually took
    assert "falling back to the staged pipeline" in capsys.readouterr().err
    _run(bam, tmp_path / "staged")
    assert _tree(tmp_path / "stream" / NAME) == _tree(tmp_path / "staged" / NAME)


def test_background_write_failure_falls_back_to_staged(staged, tmp_path, monkeypatch, capsys):
    def refuse(self, path, level=6, index=True):
        raise OSError("disk gone")

    monkeypatch.setattr(columnar.MemoryBam, "write", refuse)
    m = _run(staged["bam"], tmp_path, "--pipeline", "streaming")
    assert m["pipeline"] == "staged"
    assert "disk gone" in capsys.readouterr().err
    assert _tree(tmp_path / NAME) == _tree(staged["base"])


def test_background_write_program_fault_raises(staged, tmp_path, monkeypatch):
    def broken(self, path, level=6, index=True):
        raise TypeError("write() got an unexpected keyword argument")

    monkeypatch.setattr(columnar.MemoryBam, "write", broken)
    with pytest.raises(TypeError, match="unexpected keyword"):
        _run(staged["bam"], tmp_path, "--pipeline", "streaming")
    assert not (tmp_path / NAME / "run.metrics.json").exists()


def test_device_error_raises_and_never_falls_back(tmp_path, monkeypatch):
    def device_fault(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(consensus_segment, "stream_vote", device_fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        torch_main(["consensus", "-i", os.path.join(REPO, "test", "data", "sample.bam"),
                    "-o", str(tmp_path), "-n", NAME, "--device", "cpu",
                    "--pipeline", "streaming"])
    assert not (tmp_path / NAME / "run.metrics.json").exists()
    assert not (tmp_path / NAME / "sscs" / f"{NAME}.sscs.sorted.bam").exists()
