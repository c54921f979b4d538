"""Durable telemetry history: periodic counter-delta NDJSON shards.

Metrics answer "what is the fleet doing *now*"; loadgen and perf_gate
runs need "what did it do over the last N minutes" without scraping and
diffing point snapshots by hand.  This module appends one NDJSON line
per recorder interval to ``history-<pid>.ndjson`` under
``CCT_HISTORY_DIR`` using the exact trace/prof shard discipline: a
single ``O_APPEND`` ``os.write`` per line (atomic under concurrent
appenders), torn tails skipped at read, ``(pid, seq)`` line identity so
fleet merges dedup the wire-buffer/shard overlap.

Each line carries the *delta* of every cumulative counter since the
previous line (intervals with no movement are skipped entirely), plus a
pass-through ``gauges`` dict for point-in-time values (canary ok/age,
queue depth) where a delta is meaningless.  A retention budget
(``CCT_HISTORY_MAX_BYTES``) evicts whole shards oldest-mtime-first —
never the live one this process is appending to — so a long-lived
daemon cannot grow the directory without bound.

Determinism firewall, same contract as trace/prof: history only writes
sidecar files, takes no RNG, and perturbs no output path — goldens stay
byte-identical with a recorder running (tier-1 tested).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time

from consensuscruncher_tpu_torch.obs import trace as _trace


def enabled() -> bool:
    """History is armed by naming a sink dir, like CCT_TRACE_DIR."""
    return bool(os.environ.get("CCT_HISTORY_DIR", ""))


def _dir() -> str:
    return os.environ.get("CCT_HISTORY_DIR", "")


def _shard_path() -> str | None:
    d = _dir()
    if not d:
        return None
    return os.path.join(d, f"history-{os.getpid()}.ndjson")


def _interval_s() -> float:
    try:
        return max(0.2, float(os.environ.get("CCT_HISTORY_INTERVAL_S",
                                             "10")))
    except ValueError:
        return 10.0


def _max_bytes() -> int:
    """Retention budget over all shards in the dir; 0 disables eviction."""
    try:
        return max(0, int(os.environ.get("CCT_HISTORY_MAX_BYTES",
                                         "16777216")))
    except ValueError:
        return 16777216


# ----------------------------------------------------------------- state

_lock = threading.Lock()
#: counter name -> last cumulative value this process recorded a delta at
_last_cum: dict[str, float] = {}
_last_t: float | None = None
_seq = 0
_tally = {"history_snapshots": 0, "history_bytes": 0,
          "history_evictions": 0}


def counter_snapshot() -> dict:
    """Current history tallies, keyed like registry COUNTERS."""
    with _lock:
        return dict(_tally)


def reset_for_tests() -> None:
    global _last_cum, _last_t, _seq
    stop()
    with _lock:
        _last_cum = {}
        _last_t = None
        _seq = 0
        for k in _tally:
            _tally[k] = 0


# ------------------------------------------------------------- appending

def _line(delta: dict, gauges: dict, dt_s: float | None, seq: int) -> dict:
    return {"v": 1, "pid": os.getpid(), "node": _trace.identity(),
            "seq": seq, "t": round(time.time(), 3),
            "dt_s": round(dt_s, 3) if dt_s is not None else None,
            "cum": delta, "gauges": gauges}


def append_snapshot(cum: dict, gauges: dict | None = None) -> int:
    """Record one interval: delta ``cum`` (flat name -> cumulative total)
    against the previous call, append one NDJSON line when anything
    moved, then enforce the retention budget.  Returns bytes written (0
    when the sink is unset or the interval was flat).  Safe from any
    thread; the whole delta-and-stamp step runs under the module lock so
    concurrent callers cannot double-count a delta."""
    path = _shard_path()
    if path is None:
        return 0
    now = time.monotonic()
    with _lock:
        global _last_t, _seq
        delta: dict[str, float] = {}
        for name, value in sorted((cum or {}).items()):
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            d = v - _last_cum.get(name, 0.0)
            _last_cum[name] = v
            if d:
                delta[name] = round(d, 3) if d != int(d) else int(d)
        dt = (now - _last_t) if _last_t is not None else None
        if not delta and _last_t is not None:
            # flat interval: nothing to say; keep _last_t so dt_s keeps
            # meaning "time since the previous WRITTEN line"
            return 0
        _last_t = now
        _seq += 1
        seq = _seq
    doc = _line(delta, dict(gauges or {}), dt, seq)
    data = (json.dumps(doc, sort_keys=True) + "\n").encode("utf-8")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.write(fd, data)
    finally:
        os.close(fd)
    with _lock:
        _tally["history_snapshots"] += 1
        _tally["history_bytes"] += len(data)
    enforce_retention()
    return len(data)


def enforce_retention() -> int:
    """Unlink whole shards, oldest mtime first, until the directory's
    ``history-*.ndjson`` total fits ``CCT_HISTORY_MAX_BYTES``.  The live
    shard this process appends to is never a candidate — a budget too
    small for even one shard stops evicting rather than eating its own
    tail.  Returns the number of shards unlinked."""
    budget = _max_bytes()
    d = _dir()
    if not budget or not d:
        return 0
    own = os.path.abspath(_shard_path() or "")
    shards = []
    total = 0
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return 0
    for name in names:
        if not (name.startswith("history-") and name.endswith(".ndjson")):
            continue
        path = os.path.join(d, name)
        try:
            st = os.stat(path)
        except OSError:
            continue
        total += st.st_size
        shards.append((st.st_mtime, name, path, st.st_size))
    evicted = 0
    for _mtime, _name, path, size in sorted(shards):
        if total <= budget:
            break
        if os.path.abspath(path) == own:
            continue
        try:
            os.unlink(path)
        except OSError:
            continue
        total -= size
        evicted += 1
    if evicted:
        with _lock:
            _tally["history_evictions"] += evicted
    return evicted


# -------------------------------------------------------------- recorder

class _Recorder(threading.Thread):
    """Daemon thread stamping one snapshot per interval from a supplier
    callable returning ``{"cum": {...}, "gauges": {...}}`` (typically a
    bound scheduler/router method).  Supplier errors are swallowed — the
    recorder must never take down the process."""

    def __init__(self, supplier, interval_s: float):
        super().__init__(name="cct-history-recorder", daemon=True)
        self.supplier = supplier
        self.interval = interval_s
        self.stop_event = threading.Event()

    def tick(self) -> int:
        try:
            doc = self.supplier() or {}
            return append_snapshot(doc.get("cum") or {},
                                   doc.get("gauges") or {})
        except Exception:
            return 0

    def run(self) -> None:
        while not self.stop_event.wait(self.interval):
            self.tick()
        self.tick()  # final stamp on shutdown so short runs leave a line


_recorder: _Recorder | None = None


def running() -> bool:
    r = _recorder
    return r is not None and r.is_alive()


def maybe_start(supplier) -> bool:
    """Start the recorder iff ``CCT_HISTORY_DIR`` names a sink.
    Idempotent; returns True when this call started it."""
    global _recorder
    if not enabled() or running():
        return False
    _recorder = _Recorder(supplier, _interval_s())
    _recorder.start()
    return True


def stop(timeout: float = 2.0) -> None:
    global _recorder
    r = _recorder
    _recorder = None
    if r is not None and r.is_alive():
        r.stop_event.set()
        r.join(timeout)


# ------------------------------------------------------- shards + collect

def read_shard(path: str) -> list[dict]:
    """Torn-line-tolerant NDJSON shard read (kill -9 mid-write skips)."""
    lines: list[dict] = []
    try:
        fh = open(path, "r", encoding="utf-8")
    except OSError:
        return lines
    with fh:
        for raw in fh:
            raw = raw.strip()
            if not raw:
                continue
            try:
                doc = json.loads(raw)
            except ValueError:
                continue
            if isinstance(doc, dict):
                lines.append(doc)
    return lines


def read_dir(d: str) -> list[dict]:
    """Every line from every ``history-*.ndjson`` shard in ``d``."""
    lines: list[dict] = []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return lines
    for name in names:
        if name.startswith("history-") and name.endswith(".ndjson"):
            lines.extend(read_shard(os.path.join(d, name)))
    return lines


def collect(node: str | None = None) -> dict:
    """Everything this process knows, for the ``history`` wire op: the
    durable shard read back (the recorder owns appends; collect never
    stamps a synthetic line, so repeated polls are read-only)."""
    path = _shard_path()
    lines = read_shard(path) if path is not None else []
    who = node or _trace.identity()
    for ln in lines:
        if who and not ln.get("node"):
            ln["node"] = who
    return {"node": who, "pid": os.getpid(), "lines": lines,
            "counters": counter_snapshot()}


def merge_history(docs: list[dict]) -> list[dict]:
    """Merge ``collect()`` replies / shard-line groups fleet-wide: dedup
    by ``(pid, seq)`` (wire reply and on-disk shard overlap by design),
    then order by timestamp so downstream trend math sees one clean
    series."""
    best: dict[tuple, dict] = {}
    for doc in docs:
        for ln in (doc or {}).get("lines") or []:
            if not isinstance(ln, dict):
                continue
            best.setdefault((ln.get("pid"), ln.get("seq")), ln)
    return sorted(best.values(),
                  key=lambda ln: (float(ln.get("t") or 0.0),
                                  str(ln.get("pid")),
                                  int(ln.get("seq") or 0)))


# ------------------------------------------------------- query + trend

def query(lines: list[dict], metric: str | None = None,
          node: str | None = None, last: int | None = None) -> list[dict]:
    """Filter merged lines for ``cct history query``: optionally by node,
    optionally projecting one metric (lines where it never moved drop
    out), optionally keeping only the most recent N."""
    out = []
    for ln in lines:
        if node and str(ln.get("node") or "") != node:
            continue
        if metric is not None:
            cum = ln.get("cum") or {}
            gauges = ln.get("gauges") or {}
            if metric not in cum and metric not in gauges:
                continue
        out.append(ln)
    if last is not None and last >= 0:
        out = out[-last:] if last else []
    return out


def trend(lines: list[dict], metric: str) -> list[dict]:
    """Per-line rate series for one metric: ``{t, node, delta, rate}``
    rows (rate = delta / dt_s when the line knows its interval).  For a
    gauge the value is reported as-is with no rate."""
    rows: list[dict] = []
    for ln in lines:
        node = str(ln.get("node") or f"pid{ln.get('pid')}")
        cum = ln.get("cum") or {}
        gauges = ln.get("gauges") or {}
        if metric in cum:
            try:
                delta = float(cum[metric])
            except (TypeError, ValueError):
                continue
            dt = ln.get("dt_s")
            rate = (round(delta / float(dt), 3)
                    if isinstance(dt, (int, float)) and dt else None)
            rows.append({"t": ln.get("t"), "node": node,
                         "delta": delta, "rate": rate})
        elif metric in gauges:
            rows.append({"t": ln.get("t"), "node": node,
                         "value": gauges[metric], "rate": None})
    return rows


def render_trend(rows: list[dict], metric: str) -> str:
    """Human table for ``cct history trend``; pure and unit-tested."""
    lines = [f"cct history — {metric}: {len(rows)} interval(s)"]
    if rows:
        lines.append(f"{'T':>14} {'NODE':<12} {'DELTA':>12} {'RATE/S':>10}")
    for r in rows:
        val = r.get("delta", r.get("value"))
        rate = r.get("rate")
        lines.append(f"{r.get('t') or 0:>14.3f} {r['node']:<12} "
                     f"{val if val is not None else '-':>12} "
                     f"{rate if rate is not None else '-':>10}")
    return "\n".join(lines) + "\n"


def _atexit_stop() -> None:
    try:
        stop(timeout=0.5)
    except Exception:
        pass


atexit.register(_atexit_stop)
