"""Flight recorder: bounded ring of recent events, atomic crash dumps.

A ``deque(maxlen=CCT_FLIGHT_RING)`` of fault firings, shed decisions,
retries, worker deaths and replay anomalies.  Recording is always on
(it is a handful of dict appends per *anomaly*, not per batch); dumping
happens on SIGQUIT, on unhandled worker death, on ``serve.shed`` and on
journal-replay anomalies — the moments PR-4's kill-9 soak previously
left only stderr for.

Dumps go through ``manifest.commit_file`` (tempfile + fsync + rename)
so a dump torn by a second crash never leaves a half-written JSON; file
names are ``flight-<pid>-<seq>.json`` under the configured dump dir
(the serve journal's directory by default, ``CCT_TRACE_DIR`` when set).

Signal-safety: the SIGQUIT handler runs ``dump()`` on the main thread,
which may already hold the recorder lock (a ``record()`` interrupted
mid-append).  ``dump()`` therefore acquires with a timeout and falls
back to an unlocked best-effort snapshot — under the GIL ``list(deque)``
is safe, at worst an event is missing — rather than deadlocking the
very post-mortem it exists to produce.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import tempfile
import threading
import time
from collections import deque

from consensuscruncher_tpu_torch.obs import trace as _trace
from consensuscruncher_tpu_torch.utils.manifest import commit_file


def _capacity() -> int:
    try:
        return max(16, int(os.environ.get("CCT_FLIGHT_RING", "512")))
    except ValueError:
        return 512


class FlightRecorder:
    def __init__(self, capacity: int | None = None):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity or _capacity())
        self._dump_dir: str | None = None
        self._seq = 0
        self._node: str | None = None
        self._epoch: int | None = None

    def set_dump_dir(self, path: str | None) -> None:
        with self._lock:
            self._dump_dir = path

    def set_identity(self, node: str | None = None,
                     epoch: int | None = None) -> None:
        """Stamp fleet identity onto future dumps: the serve ``--node``
        name (or router id) and the highest router epoch this process
        has seen.  A dump found on a shared filesystem after a chaos
        run is attributable without guessing from pids."""
        with self._lock:
            if node is not None:
                self._node = str(node)
            if epoch is not None:
                self._epoch = int(epoch)

    def record(self, kind: str, **fields) -> None:
        ev = {"t": round(time.time(), 6), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._events.append(ev)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def dump(self, path: str | None = None, reason: str = "manual") -> str | None:
        locked = self._lock.acquire(timeout=1.0)
        try:
            events = list(self._events)
            dump_dir = self._dump_dir
            node, epoch = self._node, self._epoch
            self._seq += 1
            seq = self._seq
        finally:
            if locked:
                self._lock.release()
        if path is None:
            if not dump_dir:
                return None
            path = os.path.join(dump_dir, f"flight-{os.getpid()}-{seq}.json")
        doc = {
            "v": 1,
            "reason": reason,
            "pid": os.getpid(),
            "dumped_at": round(time.time(), 6),
            "events": events,
            "trace_events": _trace.recent_events(limit=256),
        }
        # "what was it DOING": last-30s collapsed stacks from the
        # CCT_PROF sampler (empty when profiling is off).  Late import:
        # prof pulls in metrics machinery the recorder itself never
        # needs, and a dump must survive any partial-import state.
        try:
            from consensuscruncher_tpu_torch.obs import prof as _prof
            doc["prof"] = _prof.flight_snapshot(last_s=30.0)
        except Exception:
            pass
        if node is not None:
            doc["node"] = node
        if epoch is not None:
            doc["router_epoch"] = epoch
        final_dir = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(final_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".flight.", dir=final_dir)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, sort_keys=True, indent=1)
                fh.write("\n")
            commit_file(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path


RECORDER = FlightRecorder()


def record(kind: str, **fields) -> None:
    RECORDER.record(kind, **fields)


def dump(path: str | None = None, reason: str = "manual") -> str | None:
    return RECORDER.dump(path, reason=reason)


def set_dump_dir(path: str | None) -> None:
    RECORDER.set_dump_dir(path)


def set_identity(node: str | None = None, epoch: int | None = None) -> None:
    RECORDER.set_identity(node=node, epoch=epoch)


def install_sigquit(recorder: FlightRecorder | None = None):
    """Install a SIGQUIT handler that dumps the flight ring; returns the
    previous handler, or None when not on the main thread (workers
    spawned by the scheduler call through here harmlessly)."""
    rec = recorder if recorder is not None else RECORDER

    def _handler(signum, _frame):
        rec.record("signal", signal="SIGQUIT")
        out = rec.dump(reason="sigquit")
        print(f"flight: SIGQUIT dump -> {out}", file=sys.stderr, flush=True)

    try:
        return signal.signal(signal.SIGQUIT, _handler)
    except ValueError:
        return None
