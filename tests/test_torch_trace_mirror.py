"""The port's spans on the torch profiler's timeline, and the per-run
counters beside them (CPU, but the case marked ``cuda``).

- Under ``torch.profiler`` a ``consensus --device cpu`` run of the test
  BAM records the command's spans as ``cct.*`` host annotations on the
  main thread, properly nested (no span stays open across a ``yield``).
- With no profiler and ``CCT_TRACE`` unset, ``span()`` is the shared
  no-op; with a profiler and ``CCT_TRACE`` unset, a span mints no id and
  records nothing into the rings; a worker thread's span is not mirrored.
- ``run.metrics.json`` carries the run's counter deltas: the SSCS vote
  calls' member-positions (size x consensus length over the families of
  two or more, worked out on the object path), no byte to a card on the
  CPU, the run thread's deflate wall; ``cli.last_run_metrics()`` is the
  same document.  A sort that outgrows its memory (a spilled sorting
  writer, a chunked ``sort_bam``) still opens ``io.sort`` and
  ``io.deflate`` and adds to the calling thread's deflate wall.
- On a card, one mesh step under the profiler records its host side's
  spans (``cuda``: skips without a card).
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from consensuscruncher_tpu_torch import cli
from consensuscruncher_tpu_torch.io import bgzf
from consensuscruncher_tpu_torch.io.bam import BamReader, sort_bam
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader, SortingBamWriter
from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.parallel.batching import consensus_length
from consensuscruncher_tpu_torch.stages.grouping import stream_families

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")
COMMAND_SPANS = ("io.decode", "grouping.block", "batching.flush", "vote.encode", "vote.call",
                 "sscs.emit", "io.sort", "io.deflate")
STEP_SPANS = ("mesh.inputs", "vote.checks", "vote.plan", "vote.launch")


def _argv(out):
    return ["consensus", "-i", SAMPLE, "-o", str(out), "-n", "s", "--scorrect", "True",
            "--device", "cpu"]


def _spans(prof):
    """``(name, start_ns, end_ns, thread)`` of every ``cct.*`` annotation."""
    return [(ev.name()[4:], ev.start_ns(), ev.start_ns() + ev.duration_ns(),
             ev.start_thread_id())
            for ev in prof.profiler.kineto_results.events() if ev.name().startswith("cct.")]


def _nested(intervals) -> bool:
    """Every two intervals are disjoint or one holds the other."""
    stack = []
    for _name, a, b, _t in sorted(intervals, key=lambda iv: (iv[1], -iv[2])):
        while stack and stack[-1] <= a:
            stack.pop()
        if stack and b > stack[-1]:
            return False
        stack.append(b)
    return True


@pytest.fixture(autouse=True)
def _untraced(monkeypatch):
    monkeypatch.delenv("CCT_TRACE", raising=False)


@pytest.fixture(scope="module")
def profiled_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mirror")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cli.main(_argv(out))
    return _spans(prof)


def test_command_spans_are_mirrored_and_nest(profiled_run):
    names = {name for name, *_ in profiled_run}
    assert set(COMMAND_SPANS) <= names
    assert {"cli.consensus", "sscs.device_loop"} <= names
    assert len({t for *_, t in profiled_run}) == 1  # the main thread's alone
    assert _nested(profiled_run)


def test_nesting_check_sees_a_crossed_span():
    assert not _nested([("a", 0, 10, 1), ("b", 5, 15, 1)])
    assert _nested([("a", 0, 10, 1), ("b", 2, 4, 1), ("c", 4, 10, 1), ("d", 10, 12, 1)])


def test_off_is_the_shared_noop():
    assert not torch.autograd._profiler_enabled()
    assert obs_trace.span("io.decode") is obs_trace._NOOP
    with obs_trace.span("io.decode") as s:
        assert s is obs_trace._NOOP


def test_mirroring_records_nothing_into_the_rings():
    obs_trace.drain_events()
    before = obs_trace._next_span_id
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs_trace.span("probe.outer"):
            with obs_trace.span("probe.inner"):
                pass
    assert obs_trace._next_span_id == before
    assert not [ev for ev in obs_trace.drain_events() if ev["name"].startswith("probe.")]
    assert [name for name, *_ in _spans(prof)] == ["probe.outer", "probe.inner"]


def test_a_worker_threads_span_is_not_mirrored():
    seen = []

    def work():
        seen.append(obs_trace.span("probe.worker"))
        with seen[0]:
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs_trace.span("probe.main"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    assert seen == [obs_trace._NOOP]
    assert [name for name, *_ in _spans(prof)] == ["probe.main"]


def _voted_member_positions(path) -> int:
    """Size x consensus length over the families of two or more, grouped
    by the object path."""
    total = 0
    with BamReader(path) as reader:
        for kind, _tag, members in stream_families(reader, reader.header):
            if kind == "family" and len(members) >= 2:
                total += len(members) * consensus_length([m.seq_len for m in members])
    return total


def test_run_metrics_carry_the_counters(tmp_path):
    cli.main(_argv(tmp_path))
    with open(tmp_path / "s" / "run.metrics.json") as fh:
        doc = json.load(fh)
    assert doc["vote_member_positions"] == _voted_member_positions(SAMPLE) > 0
    assert 0 < doc["vote_output_positions"] < doc["vote_member_positions"]
    assert doc["bytes_h2d"] == doc["bytes_d2h"] == 0
    assert 0 < doc["deflate_wall_s"] <= doc["wall_s"]
    assert cli.last_run_metrics() == doc


def _records(path) -> bytes:
    with ColumnarReader(path) as reader:
        return b"".join(b.buf[: int(b.rec_off[-1])].tobytes() for b in reader.batches())


def _spilled_writer(sample, out):
    """A sorting writer whose buffer spills finishes through ``sort_bam``."""
    with BamReader(sample) as reader:
        writer = SortingBamWriter(out, reader.header, max_raw_bytes=4096)
        for read in reader:
            writer.write(read)
    assert writer._spill is not None
    return writer.close


def _chunked_sort(sample, out):
    """A sort beyond its in-memory bound: sorted chunks and the columnar merge."""
    return lambda: sort_bam(sample, out, max_in_memory=64)


@pytest.mark.parametrize("finish", [_spilled_writer, _chunked_sort])
def test_sorts_beyond_memory_are_in_the_deflate_wall(tmp_path, finish):
    run = finish(SAMPLE, tmp_path / "out.bam")
    before = bgzf.caller_wall_us()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    assert bgzf.caller_wall_us() > before
    spans = _spans(prof)
    assert {"io.decode", "io.sort", "io.deflate"} <= {name for name, *_ in spans}
    assert max(spans, key=lambda sp: sp[2])[0] == "io.deflate"  # the output's last write
    assert _nested(spans)
    sort_bam(SAMPLE, tmp_path / "want.bam")
    assert _records(tmp_path / "out.bam") == _records(tmp_path / "want.bam")


@pytest.mark.cuda
def test_mesh_step_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from consensuscruncher_tpu_torch.parallel import mesh

    card = torch.device("cuda", 0)
    gen = torch.Generator(device=card)
    gen.manual_seed(7)
    pairs, slots, length = 64, 8, 100
    planes = [torch.randint(0, 4 if i % 2 == 0 else 41, (pairs, slots, length), generator=gen,
                            device=card, dtype=torch.uint8) for i in range(4)]
    sizes = [np.full(pairs, slots, np.int32), np.full(pairs, slots // 2, np.int32)]
    step = mesh.full_pipeline_step(mesh.make_mesh(devices=[card]))
    args = (planes[0], planes[1], sizes[0], planes[2], planes[3], sizes[1])
    step(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()
    spans = _spans(prof)
    assert set(STEP_SPANS) <= {name for name, *_ in spans}
    assert _nested(spans)
