"""The port's streaming dataflow primitives (``core.streamgraph``), held to
the JAX package's unit tests of its own (``tests/test_streamgraph.py``):
channel backpressure, poison propagation, operator fault conversion, the
read-ahead batch stream and the write-behind capture.  The JAX package's
two chaos tests fire its fault-injection sites, which the port does not
have; in their place, the port's one fallback signal: a background write
failure surfaces as ``StreamFallback``, and so does a sort buffer that
spilled (``tests/test_torch_streaming.py`` covers the CLI half)."""

import threading
import time

import numpy as np
import pytest

from consensuscruncher_tpu_torch.core.streamgraph import (
    BatchStream,
    Channel,
    ChannelClosed,
    Operator,
    StreamFallback,
    StreamOut,
)
from consensuscruncher_tpu_torch.io import columnar
from consensuscruncher_tpu_torch.io.bam import BamHeader, merge_memory_bams
from consensuscruncher_tpu_torch.io.columnar import SortingBamWriter


def test_channel_fifo_and_clean_close():
    ch = Channel(capacity=4)
    for i in range(3):
        ch.put(i)
    ch.close()
    assert list(ch) == [0, 1, 2]


def test_channel_backpressure_blocks_producer_until_drained():
    ch = Channel(capacity=1)
    ch.put(0)
    done = []

    def producer():
        ch.put(1)  # at capacity: must block until the consumer pulls
        done.append(True)
        ch.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.05)
    assert not done, "producer ran through a full channel"
    assert list(ch) == [0, 1]
    t.join(5)
    assert done


def test_channel_fail_drops_queue_and_poisons_consumer():
    ch = Channel(capacity=2)
    ch.put("item")
    ch.fail(RuntimeError("boom"))
    # fail-fast: the poison outranks queued items
    with pytest.raises(RuntimeError, match="boom"):
        ch.get()


def test_channel_put_after_close_raises():
    ch = Channel()
    ch.close()
    with pytest.raises(ChannelClosed):
        ch.put(1)


def test_channel_fail_releases_blocked_producer():
    ch = Channel(capacity=1)
    ch.put(0)
    errs = []

    def producer():
        try:
            ch.put(1)
        except ChannelClosed:
            errs.append("closed")

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.05)
    ch.fail(ChannelClosed("consumer walked away"))
    t.join(5)
    assert errs == ["closed"]


def test_operator_pumps_and_closes():
    ch = Channel(capacity=2)
    Operator("t", iter(range(5)), ch)
    assert list(ch) == list(range(5))


def test_operator_callable_source_built_on_worker_thread():
    built_on = []

    def make():
        built_on.append(threading.current_thread().name)
        return iter([1, 2])

    ch = Channel(capacity=2)
    Operator("lazy", make, ch)
    assert list(ch) == [1, 2]
    assert built_on == ["cct-stream-lazy"]


def test_operator_exception_poisons_channel():
    def src():
        yield 1
        raise ValueError("mid-stream")

    ch = Channel(capacity=2)
    Operator("t", src(), ch)
    with pytest.raises(ValueError, match="mid-stream"):
        list(ch)


class _FakeSource:
    """Duck-typed batch source (MemoryBam shape: header/batches/close)."""

    def __init__(self, items):
        self.header = "hdr"
        self.items = items
        self.closed = 0

    def batches(self, batch_bytes=None):
        return iter(self.items)

    def close(self):
        self.closed += 1


def test_batchstream_reads_ahead_and_closes_source():
    src = _FakeSource([1, 2, 3])
    bs = BatchStream(src, capacity=2)
    assert bs.header == "hdr"
    assert list(bs.batches()) == [1, 2, 3]
    bs.close()
    assert src.closed == 1


def test_streamout_capture_keeps_memory_and_write_behind(tmp_path):
    writes = []

    class Mem:
        def write(self, path, level=6, index=True):
            writes.append((path, level, index))

    out = StreamOut(taps=False)
    m = Mem()
    out.capture("sscs", m, file_path=str(tmp_path / "a.bam"), level=1)
    out.capture("singleton", Mem(), file_path=None)  # tap off: memory only
    out.drain()
    assert out.memory["sscs"] is m
    assert writes == [(str(tmp_path / "a.bam"), 1, True)]


def test_streamout_drain_surfaces_background_error():
    class Bad:
        def write(self, path, level=6, index=True):
            raise OSError("disk gone")

    out = StreamOut()
    out.capture("x", Bad(), file_path="/nonexistent/never-written.bam")
    with pytest.raises(StreamFallback, match="disk gone") as info:
        out.drain()
    assert isinstance(info.value.__cause__, OSError)


def test_streamout_drain_raises_a_program_fault_as_is():
    class Broken:
        def write(self, path, level=6, index=True):
            raise TypeError("write() got an unexpected keyword argument")

    out = StreamOut()
    out.capture("x", Broken(), file_path="/nonexistent/never-written.bam")
    with pytest.raises(TypeError, match="unexpected keyword"):
        out.drain()


def _record() -> np.ndarray:
    """One encoded BAM record: ref 0, pos 0, an empty qname, no cigar or
    sequence (33 bytes after its length prefix)."""
    rec = np.zeros(37, np.uint8)
    rec[:4] = np.frombuffer(np.int32(33).tobytes(), np.uint8)
    rec[12] = 1  # l_read_name: the NUL alone
    return rec


def test_spilled_sort_buffer_raises_stream_fallback(tmp_path, monkeypatch):
    header = BamHeader(text="@HD\tVN:1.6\tSO:coordinate\n", refs=[("chr1", 1000)])
    writer = SortingBamWriter(str(tmp_path / "x.bam"), header, max_raw_bytes=64)
    for _ in range(3):
        writer.write_encoded(_record())
    with pytest.raises(StreamFallback, match="spilled"):
        writer.close_to_memory()
    writer.abort()
    small = SortingBamWriter(str(tmp_path / "y.bam"), header)
    small.write_encoded(_record())
    mem = small.close_to_memory()
    assert mem.n == 1 and mem.nbytes == 37
    monkeypatch.setattr(columnar, "_default_sort_buffer_bytes", lambda: 40)
    with pytest.raises(StreamFallback, match="sort budget"):
        merge_memory_bams([mem, mem])
