"""Streaming dataflow primitives: bounded channels, operator threads, taps.

Port of ``consensuscruncher_tpu/core/streamgraph.py``.  In ``--pipeline
streaming`` mode the consensus chain moves sorted record batches between
stages as bounded in-memory flows instead of writing, BGZF-deflating,
re-reading and re-sorting an intermediate BAM at every stage boundary.
The pieces:

- :class:`Channel` — a bounded queue with backpressure.  ``put`` blocks
  once ``capacity`` items are in flight; ``fail`` poisons the channel so
  errors cross thread boundaries exactly once and promptly.
- :class:`Operator` — a daemon producer thread pumping an iterable into
  a channel, converting its exceptions into channel poison rather than
  silent thread death.
- :class:`BatchStream` — bounded read-ahead over an in-memory BAM,
  duck-compatible with ``ColumnarReader`` (``.header`` / ``.batches()``
  / ``.close()``) so unchanged stage code consumes it transparently.
- :class:`StreamOut` — the capture surface stages hand their sorted
  outputs to: keeps the in-memory BAM for the next stage and schedules
  any file materialization (finals always, intermediates only as debug
  taps) on a bounded write-behind pool, overlapping deflate+IO with the
  next stage's device work.
- :class:`StreamFallback` — the two host-side conditions under which the
  CLI re-runs a streaming run on the staged pipeline: a sort buffer that
  spilled to disk (no in-memory hand-off exists past it) and a failed
  write-behind materialization.  Every other exception propagates.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Iterable, Iterator

from consensuscruncher_tpu_torch.parallel.prefetch import WriteBehind

_SENTINEL = object()


class StreamFallback(RuntimeError):
    """A streaming run cannot finish in memory for a host-side reason (a
    spilled sort buffer, a failed background write); the staged pipeline
    can.  The only exception the CLI's fallback catches."""


def _fallback_on_failure(fn, *args, **kwargs):
    """Call ``fn``; a background write's I/O failure (an ``OSError``,
    which ``WriteBehind`` re-raises here) becomes :class:`StreamFallback`.
    Any other exception is a fault of the program and propagates."""
    try:
        return fn(*args, **kwargs)
    except OSError as exc:
        raise StreamFallback(f"background write failed: {exc}") from exc


class ChannelClosed(RuntimeError):
    """``put()`` on a channel whose consumer side has gone away."""


class Channel:
    """Bounded producer→consumer channel with backpressure.

    Single-consumer, any number of producers.  ``close()`` ends iteration
    once queued items drain; ``fail(exc)`` drops queued items and
    re-raises ``exc`` at the consumer's next pull (fail-fast: a poisoned
    stage must not keep feeding the stage downstream).
    """

    def __init__(self, capacity: int = 2):
        self._cap = max(1, int(capacity))
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._exc: BaseException | None = None

    def _check_open(self) -> None:
        if self._closed or self._exc is not None:
            raise ChannelClosed("channel closed under the producer")

    def put(self, item) -> None:
        with self._cond:
            while len(self._q) >= self._cap:
                self._check_open()
                self._cond.wait(0.5)
            self._check_open()
            self._q.append(item)
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def fail(self, exc: BaseException) -> None:
        with self._cond:
            if self._exc is None:
                self._exc = exc
            self._closed = True
            self._q.clear()
            self._cond.notify_all()

    def get(self):
        """Next item, ``_SENTINEL`` at clean end, raises on poison."""
        with self._cond:
            while True:
                if self._exc is not None:
                    raise self._exc
                if self._q:
                    item = self._q.popleft()
                    self._cond.notify_all()
                    return item
                if self._closed:
                    return _SENTINEL
                self._cond.wait(0.5)

    def __iter__(self) -> Iterator:
        while True:
            item = self.get()
            if item is _SENTINEL:
                return
            yield item


class Operator:
    """Daemon thread pumping ``source`` into ``out``.

    ``source`` is an iterable or a zero-arg callable returning one (use a
    callable when building the iterator itself is expensive — it then
    runs on the operator thread, not the caller's).  The thread starts
    immediately, so read-ahead begins before the consumer's first pull.
    Exceptions poison ``out``; a consumer that walks away (``fail`` on
    the channel) just ends the pump quietly.
    """

    def __init__(self, name: str,
                 source: Iterable | Callable[[], Iterable],
                 out: Channel):
        self.name = name
        self._src = source
        self._out = out
        self._thread = threading.Thread(
            target=self._run, name=f"cct-stream-{name}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            it = self._src() if callable(self._src) else self._src
            for item in it:
                self._out.put(item)
        except ChannelClosed:
            pass  # consumer closed first: normal teardown
        except BaseException as exc:
            self._out.fail(exc)
        else:
            self._out.close()

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)


class BatchStream:
    """Bounded read-ahead over an in-memory BAM's record batches.

    Wraps anything exposing ``.header`` / ``.batches()`` / ``.close()``
    (a :class:`~consensuscruncher_tpu_torch.io.columnar.MemoryBam` between
    stages) and serves the same interface, with an :class:`Operator`
    slicing batches ``capacity`` ahead of the consumer — the host-side
    gather/copy overlaps the consumer's device work.
    """

    def __init__(self, source, capacity: int = 2):
        self._source = source
        self.header = source.header
        self._capacity = max(1, int(capacity))
        self._chan: Channel | None = None
        self._op: Operator | None = None

    def batches(self) -> Iterator:
        self._chan = Channel(self._capacity)
        self._op = Operator("batches", self._source.batches, self._chan)
        return iter(self._chan)

    def close(self) -> None:
        if self._chan is not None:
            # Release a producer blocked on a full channel before closing
            # the underlying source it is reading from.
            self._chan.fail(ChannelClosed("stream consumer closed"))
            if self._op is not None:
                self._op.join(timeout=30.0)
        self._source.close()


class StreamOut:
    """Capture surface for stage outputs in streaming mode.

    Stages call ``capture(name, mem, file_path=...)`` with the sorted
    in-memory BAM they would otherwise have committed to disk.  The
    memory is kept for the next stage; when ``file_path`` is given (final
    outputs always; intermediates only when the run asked for debug taps)
    the BGZF materialization runs on a bounded write-behind pool so
    deflate+IO overlaps downstream work.  ``drain()`` raises
    :class:`StreamFallback` from the first background write failure
    (atomic tmp+rename writes make half-written finals invisible, so the
    staged re-run starts clean).
    """

    def __init__(self, taps: bool = False, depth: int = 2):
        self.taps = bool(taps)
        self.memory: dict[str, object] = {}
        self._wb = WriteBehind(depth=depth)

    def capture(self, name: str, mem, file_path=None, level: int = 6,
                index: bool = True) -> None:
        self.memory[name] = mem
        if file_path is not None:
            self.submit(mem.write, file_path, level=level, index=index)

    def submit(self, fn, *args, **kwargs) -> None:
        """Run ``fn`` on the write-behind pool (e.g. an all_unique merge
        that can overlap the next stage's device work)."""
        _fallback_on_failure(self._wb.submit, fn, *args, **kwargs)

    def drain(self) -> None:
        _fallback_on_failure(self._wb.drain)

    def abort(self) -> None:
        self._wb.abort()
