"""Host<->device double-buffering: background producer + one batch in flight.

Port of ``consensuscruncher_tpu/parallel/prefetch.py``.  Four pieces:

- :func:`prefetch` / :func:`start_prefetch` — run any iterator on a daemon
  thread behind a bounded queue.  Order-preserving (single FIFO),
  exception-propagating, and safe to abandon mid-stream (the producer
  notices and exits instead of blocking on a full queue forever).
- :func:`pipelined` — software-pipeline a dispatch/fetch pair over a batch
  stream with exactly one batch in flight: dispatch(k+1) happens before
  fetch(k).
- :func:`start_fetch` — what makes that overlap real with PyTorch.  JAX
  dispatch returns futures, so fetching batch *k* after dispatching *k+1*
  waits for *k* alone.  ``.cpu()`` on the current stream instead waits for
  every launch queued so far, *k+1*'s included.  So a dispatch starts its
  outputs' download into pinned host buffers (non-blocking) and records an
  event behind it; the fetch waits on that event only.
- :class:`WriteBehind` — a bounded background pool for the streaming
  pipeline's file writes (``core.streamgraph.StreamOut``).

Thread-safety contract for ``prefetch(gen)``: the generator body runs on
the producer thread while consumers run downstream of the queue — state
shared between the generator and its consumer must be confined to one side
or be GIL-atomic.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Callable, Iterable, Iterator, TypeVar

import numpy as np
import torch

T = TypeVar("T")
_SENTINEL = object()

DEFAULT_DEPTH = 2


def prefetch(iterable: Iterable[T], depth: int = DEFAULT_DEPTH) -> Iterator[T]:
    """Yield from ``iterable``, produced on a background daemon thread.

    ``depth`` bounds the number of buffered items (memory bound for big
    batches).  ``depth <= 0`` degrades to plain iteration (no thread).
    Exceptions raised by the producer re-raise at the consumer's next pull,
    and abandoning the consumer (``close()`` / GC) unblocks the producer.

    The producer thread starts at the consumer's FIRST pull (generator
    semantics); :func:`start_prefetch` starts it at once.
    """
    if depth <= 0:
        yield from iterable
        return
    yield from start_prefetch(iterable, depth)


def start_prefetch(iterable: Iterable[T], depth: int = DEFAULT_DEPTH) -> Iterator[T]:
    """:func:`prefetch` with the producer thread started immediately.

    Returns the draining iterator; the producer fills the bounded queue in
    the background from the moment this function returns, whether or not
    the consumer has begun pulling.  Same ordering/exception/abandonment
    contract as :func:`prefetch`.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    failure: list[BaseException] = []

    def worker():
        try:
            for item in iterable:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as exc:  # re-raised on the consumer side
            failure.append(exc)
        finally:
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=worker, daemon=True, name="cct-prefetch")
    thread.start()  # eager: producing begins before the first pull
    return _Prefetched(q, stop, failure, thread)


class _Prefetched:
    """Draining iterator over a running producer thread.

    A plain class (not a generator) so :meth:`close` works even when the
    consumer never pulled a single item — closing an unstarted generator
    skips its ``finally`` and would leak the producer thread.
    """

    def __init__(self, q, stop, failure, thread):
        self._q, self._stop, self._failure, self._thread = q, stop, failure, thread
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._shutdown()
            if self._failure:
                raise self._failure[0]
            raise StopIteration
        return item

    def close(self) -> None:
        self._shutdown()

    def __del__(self):
        # GC safety net: an abandoned iterator must at least signal the
        # producer to stop — without the join/raise, which are close()'s
        # deterministic path.
        self._done = True
        self._stop.set()

    def _shutdown(self) -> None:
        if self._done:
            return
        self._done = True
        self._stop.set()
        # close() must not return while the producer can still touch state
        # shared with the consumer's cleanup.  The producer polls `stop`
        # every 0.1 s, so this join is bounded unless the underlying
        # iterable itself blocks indefinitely.
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            raise RuntimeError(
                "prefetch producer thread failed to stop within 30s; "
                "the source iterable is blocked"
            ) from sys.exc_info()[1]


class WriteBehind:
    """Bounded background writer pool: overlap output serialization with
    downstream compute.

    The streaming pipeline's final/tap BAM writes are pure sinks — nothing
    downstream reads them — so they can run behind the next stage's device
    work instead of serializing it.  ``submit`` blocks once ``depth`` writes
    are in flight (memory bound: each pending write pins its source arrays),
    and the FIRST failure is sticky: later submits re-raise it immediately
    and :meth:`drain` re-raises it after all workers stop (the streaming
    pipeline turns it into its fall-back-to-staged signal).
    """

    def __init__(self, depth: int = 2):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(
            max_workers=max(1, depth), thread_name_prefix="cct-writebehind")
        self._depth = max(1, depth)
        self._pending: list = []
        self._error: BaseException | None = None

    def _reap(self, block: bool) -> None:
        while self._pending and (block or len(self._pending) >= self._depth):
            fut = self._pending.pop(0)
            try:
                fut.result()
            except BaseException as exc:
                if self._error is None:
                    self._error = exc

    def submit(self, fn, *args, **kwargs) -> None:
        if self._error is not None:
            raise self._error
        self._pending.append(self._pool.submit(fn, *args, **kwargs))
        self._reap(block=False)
        if self._error is not None:
            raise self._error

    def drain(self) -> None:
        """Wait for every pending write; re-raise the first failure."""
        self._reap(block=True)
        self._pool.shutdown(wait=True)
        if self._error is not None:
            raise self._error

    def abort(self) -> None:
        """Best-effort teardown: wait out in-flight writes, swallow errors
        (used on the fall-back path where the error is already being
        handled)."""
        try:
            self._reap(block=True)
        except BaseException:
            pass
        self._error = None
        self._pool.shutdown(wait=True)


def pipelined(
    batches: Iterable[T],
    dispatch: Callable[[T], object],
    fetch: Callable[[T, object], Iterable],
    on_dispatch: Callable[[T, object], None] | None = None,
) -> Iterator:
    """One-batch-in-flight software pipeline over ``batches``.

    For each batch: ``handle = dispatch(batch)`` (should not wait for the
    device — see :func:`start_fetch`), then the PREVIOUS batch's
    ``fetch(prev_batch, prev_handle)`` results are yielded — so the device
    is always working on one batch ahead of the host-side drain.  Ordering
    across batches is preserved, and an exception from any of the three
    callables propagates.

    ``on_dispatch(batch, handle)`` fires right after each dispatch, before
    any fetch — the point where the device handle exists but nothing has
    been drained.  Must be cheap and must not block on device results.
    """
    inflight: tuple[T, object] | None = None
    for batch in batches:
        handle = dispatch(batch)
        if on_dispatch is not None:
            on_dispatch(batch, handle)
        if inflight is not None:
            yield from fetch(*inflight)
        inflight = (batch, handle)
    if inflight is not None:
        yield from fetch(*inflight)


class PendingFetch:
    """Device tensors on their way to the host (see :func:`start_fetch`)."""

    def __init__(self, host: list[torch.Tensor], event):
        self._host = host
        self._event = event

    def result(self) -> list[np.ndarray]:
        """Wait for this download alone; the host copies as numpy arrays."""
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def start_fetch(*tensors: torch.Tensor) -> PendingFetch:
    """Start copying ``tensors`` to the host without waiting: on the card,
    non-blocking copies into pinned buffers on the current stream, then an
    event; CPU tensors need no copy."""
    if all(t.device.type == "cpu" for t in tensors):
        return PendingFetch(list(tensors), None)
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    return PendingFetch(host, event)
