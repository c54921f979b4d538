"""The comma-separated sample batch of the port against the JAX package (CPU).

- ``sample.bam,sample_bcerr.bam`` writes one tree per sample, each equal
  record by record (tags included), stats less ``backend`` lines and
  ``qc.json`` to that sample's own run, and record by record to the JAX
  CLI's batch; the second sample was prestaged (a producer thread decoded
  it while the first ran).
- ``--name`` with a batch is refused with the reference's message.
- A bad second input does not kill the first sample: its prestage failure
  is reported, the first tree completes, and the bad input then fails on
  its own turn.
- Every prestage is closed: no producer thread outlives the batch, also
  when a sample fails or the dense wire cannot consume the prestage; a
  sample whose streaming run falls back to staged decodes its input anew
  (the consumed prestage is not handed on).
"""

import json
import os
import threading

import pytest

from consensuscruncher_tpu.cli import main as jax_main
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.io.bam import BamReader, BamWriter
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.stages import sscs_maker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")
NAMES = ("sample", "sample_bcerr")
BATCH = ",".join(os.path.join(DATA, f"{n}.bam") for n in NAMES)


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _bams(base):
    return sorted(os.path.relpath(os.path.join(root, f), base)
                  for root, _dirs, files in os.walk(base) for f in files if f.endswith(".bam"))


def _no_backend(path):
    with open(path) as fh:
        return [ln for ln in fh if "backend" not in ln]


def _producers():
    return [t for t in threading.enumerate() if t.name == "cct-prefetch" and t.is_alive()]


def test_batch_equals_single_runs_and_jax(tmp_path, capsys, monkeypatch):
    consumed = []
    real = sscs_maker.run_sscs

    def spy(*a, **k):
        consumed.append(k.get("prestaged") is not None)
        return real(*a, **k)

    monkeypatch.setattr(torch_cli, "run_sscs", spy)
    res = torch_cli.main(["consensus", "-i", BATCH, "-o", str(tmp_path / "batch"),
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"batch sample {os.path.join(DATA, 'sample.bam')} (next sample prestaging)" in out
    assert consumed == [False, True]  # the second sample's decode was prestaged
    assert sorted(res) == sorted(BATCH.split(","))
    assert _producers() == []
    jax_main(["consensus", "-i", BATCH, "-o", str(tmp_path / "jax"), "--backend", "xla_cpu"])
    for name in NAMES:
        torch_cli.main(["consensus", "-i", os.path.join(DATA, f"{name}.bam"),
                        "-o", str(tmp_path / "single"), "--device", "cpu"])
        base, single, jax = (tmp_path / d / name for d in ("batch", "single", "jax"))
        bams = _bams(str(base))
        assert bams == _bams(str(single)) == _bams(str(jax)) and len(bams) == 11
        for rel in bams:
            want = _records(str(single / rel))
            assert _records(str(base / rel)) == want == _records(str(jax / rel)), rel
        for rel in (f"sscs/{name}.sscs_stats.txt", f"dcs/{name}.dcs_stats.txt",
                    f"singleton/{name}.singleton_stats.txt", f"sscs/{name}.read_families.txt"):
            assert _no_backend(base / rel) == _no_backend(single / rel), rel
        with open(base / "qc.json") as fh, open(single / "qc.json") as gh:
            assert json.load(fh) == json.load(gh)
        for png in ("family_size", "read_recovery", "stage_times"):
            assert (base / "plots" / f"{name}.{png}.png").exists()


def test_streaming_fallback_decodes_a_prestaged_sample_anew(tmp_path):
    """A batch sample whose streaming run falls back to staged (its reads
    carry tags, as an aligner writes them) was prestaged; the streaming
    attempt consumed that prestage, so the staged run decodes the input
    anew and writes the sample's own records.  (The JAX CLI hands the
    consumed prestage on and writes an empty SSCS BAM: a fault of the
    reference, not kept.)"""
    tagged = str(tmp_path / "tagged.bam")
    with BamReader(os.path.join(DATA, "sample.bam")) as reader, \
            BamWriter(tagged, reader.header) as writer:
        for read in reader:
            read.tags = {"NM": ("i", 0), **read.tags}
            writer.write(read)
    torch_cli.main(["consensus", "-i", f"{os.path.join(DATA, 'sample.bam')},{tagged}",
                    "-o", str(tmp_path / "batch"), "--device", "cpu", "--pipeline", "streaming"])
    torch_cli.main(["consensus", "-i", tagged, "-o", str(tmp_path / "single"), "--device", "cpu"])
    base, single = tmp_path / "batch" / "tagged", tmp_path / "single" / "tagged"
    with open(base / "sscs" / "tagged.sscs_stats.json") as fh:
        assert json.load(fh)["total_reads"] > 0
    bams = _bams(str(single))
    assert bams == _bams(str(base)) and len(bams) == 11
    for rel in bams:
        assert _records(str(base / rel)) == _records(str(single / rel)), rel
    assert _producers() == []


def test_batch_refuses_name(tmp_path):
    with pytest.raises(SystemExit, match="--name cannot combine"):
        torch_cli.main(["consensus", "-i", BATCH, "-o", str(tmp_path), "-n", "clash",
                        "--device", "cpu"])
    assert not (tmp_path / "clash").exists()


def test_bad_second_input_does_not_kill_the_first(tmp_path, capsys):
    bad = str(tmp_path / "missing.bam")
    first = os.path.join(DATA, "sample.bam")
    with pytest.raises(FileNotFoundError):
        torch_cli.main(["consensus", "-i", f"{first},{bad}", "-o", str(tmp_path / "o"),
                        "--device", "cpu"])
    err = capsys.readouterr().err
    assert f"prestage of {bad} failed" in err
    assert (tmp_path / "o" / "sample" / "all_unique" / "sample.all.unique.dcs.bam").exists()
    assert (tmp_path / "o" / "sample" / "qc.json").exists()
    assert _producers() == []


def test_every_prestage_is_closed(tmp_path, monkeypatch):
    closed = []
    real_close = sscs_maker.PrestagedBlocks.close

    def counting_close(self):
        closed.append(self)
        real_close(self)

    monkeypatch.setattr(sscs_maker.PrestagedBlocks, "close", counting_close)
    # the dense wire cannot consume a prestage: closed, and decoded normally
    torch_cli.main(["consensus", "-i", BATCH, "-o", str(tmp_path / "dense"), "--device", "cpu",
                    "--wire", "dense"])
    assert closed and _producers() == []
    # a sample that fails: the next sample's prestage is closed before the raise
    closed.clear()

    def boom(args):
        raise RuntimeError("sample failed")

    monkeypatch.setattr(torch_cli, "_consensus_one", boom)
    with pytest.raises(RuntimeError, match="sample failed"):
        torch_cli.main(["consensus", "-i", BATCH, "-o", str(tmp_path / "fail"),
                        "--device", "cpu"])
    assert len(closed) == 1 and _producers() == []
