"""Always-on sampling profiler: span-attributed stacks, wall attribution.

The third leg of the obs/ subsystem (metrics count, traces correlate,
profiles *attribute*).  Two collection planes share one module:

1. **Sampled stacks.**  A daemon thread walks ``sys._current_frames()``
   at ``CCT_PROF_HZ`` and aggregates collapsed stacks (outermost-first
   ``module.func`` frames, prefixed with the innermost open trace span
   on that thread) into a bounded dict — overflow past
   ``CCT_PROF_MAX_STACKS`` distinct stacks is *counted* (``prof_drops``)
   never resized, so a pathological workload cannot balloon memory.
   The aggregate is drained to ``prof-<pid>.ndjson`` shards under
   ``CCT_PROF_DIR`` using the trace-shard discipline: one NDJSON line
   per flush, single ``O_APPEND`` ``os.write`` (atomic per line, torn
   lines skipped at read).  Each line carries a ``(pid, seq)`` identity
   so fleet merges dedup the wire-buffer/shard overlap exactly.

2. **Span deltas.**  An observer hook installed into ``obs.trace``
   rides every ``_Span`` enter/exit (even with ``CCT_TRACE`` off): it
   maintains the per-thread open-span name stack the sampler attributes
   against, and on ``serve.job`` exit captures deltas of thread CPU,
   ``device_dispatch_s`` histogram sum and BGZF deflate wall so every
   job span self-reports ``{host_cpu_ms, device_dispatch_ms,
   deflate_ms, queue_wait_ms}`` — and the process-wide attribution
   accumulator decomposes job wall into {queue, routing, host compute,
   device dispatch, deflate, io} for ``cct prof``'s report.

Determinism firewall, same contract as tracing: the profiler only ever
writes sidecar files, takes no RNG, and perturbs no output path — the
goldens stay byte-identical with ``CCT_PROF=1`` (tier-1 tested).
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from collections import deque

from consensuscruncher_tpu_torch.obs import metrics as _metrics
from consensuscruncher_tpu_torch.obs import trace as _trace

_TRUE_WORDS = ("1", "true", "on", "yes")

# (raw env string, parsed flag) — same trick as trace.enabled(): compare
# the raw string so monkeypatch.setenv invalidates the cache.
_env_cache: tuple[str, bool] = ("\x00unset", False)


def enabled() -> bool:
    global _env_cache
    raw = os.environ.get("CCT_PROF", "")
    if raw != _env_cache[0]:
        _env_cache = (raw, raw.strip().lower() in _TRUE_WORDS)
    return _env_cache[1]


def _hz() -> float:
    try:
        return min(500.0, max(1.0, float(os.environ.get("CCT_PROF_HZ",
                                                        "67"))))
    except ValueError:
        return 67.0


def _max_stacks() -> int:
    try:
        return max(16, int(os.environ.get("CCT_PROF_MAX_STACKS", "2048")))
    except ValueError:
        return 2048


def _flush_s() -> float:
    try:
        return max(0.5, float(os.environ.get("CCT_PROF_FLUSH_S", "5")))
    except ValueError:
        return 5.0


# ----------------------------------------------------------------- state

_lock = threading.Lock()
# tid -> open trace-span names, innermost last (fed by the observer; the
# sampler reads the top to attribute each sample)
_span_stacks: dict[int, list[str]] = {}
# collapsed stack -> sample count since the last flush
_agg: dict[str, int] = {}
# per-second sample buckets for last-N-seconds flight snapshots; never
# drained by flush — a postmortem wants "what was it doing just now"
# regardless of shard cadence
_window: deque = deque(maxlen=120)

_ATTR_KEYS = ("queue_ms", "routing_ms", "host_cpu_ms",
              "device_dispatch_ms", "deflate_ms", "io_ms",
              "job_wall_ms", "jobs")


def _zero_attr() -> dict:
    return {k: 0.0 for k in _ATTR_KEYS}


# wall attribution accumulated since the last flush (drained per shard
# line so fleet merges can simply sum deduped lines)
_attr = _zero_attr()

# process-wide cumulative tallies, overlaid into the scheduler/router
# metrics docs (names registered in obs/registry.py COUNTERS)
_tally = {"prof_samples": 0, "prof_drops": 0, "prof_shards": 0}
_flushed_drops = 0
_seq = 0

# router-side spans whose wall is the fleet's routing overhead bucket
_ROUTE_SPANS = frozenset({
    "route.submit", "route.forward", "route.resubmit", "route.adopt_job",
    "route.journal_answer", "route.cache_answer",
})


def counter_snapshot() -> dict:
    """Current profiler tallies, keyed like registry COUNTERS."""
    with _lock:
        return dict(_tally)


# -------------------------------------------------------------- observer

def _deflate_wall_us() -> int:
    # bgzf deliberately imports nothing from obs/; the late import here
    # keeps that acyclic (and tolerates the io package being absent in
    # stripped-down test processes)
    try:
        from consensuscruncher_tpu_torch.io import bgzf
        return int(bgzf.write_stats()["deflate_wall_us"])
    except Exception:
        return 0


class _Observer:
    """Rides ``trace._Span`` enter/exit.  Exceptions never escape into
    the span path (trace wraps the calls), but the methods are written
    to not raise anyway — this runs inside every job."""

    __slots__ = ()

    def span_enter(self, name: str):
        tid = threading.get_ident()
        with _lock:
            _span_stacks.setdefault(tid, []).append(name)
        if name == "serve.job":
            # begin-state for the exit-side deltas; thread_time excludes
            # blocked time so host compute is CPU, not wall
            return (time.thread_time(),
                    _metrics.histogram_sum("device_dispatch_s"),
                    _deflate_wall_us())
        return None

    def span_exit(self, name: str, token, args: dict, dur_s: float) -> None:
        tid = threading.get_ident()
        with _lock:
            stack = _span_stacks.get(tid)
            if stack:
                if stack[-1] == name:
                    stack.pop()
                elif name in stack:
                    stack.remove(name)  # unbalanced exit: best effort
                if not stack:
                    _span_stacks.pop(tid, None)
        if name in _ROUTE_SPANS:
            with _lock:
                _attr["routing_ms"] += dur_s * 1e3
            return
        if name != "serve.job" or token is None:
            return
        cpu0, device0, deflate0 = token
        wall_ms = dur_s * 1e3
        host_ms = max(0.0, (time.thread_time() - cpu0) * 1e3)
        device_ms = max(0.0, (_metrics.histogram_sum("device_dispatch_s")
                              - device0) * 1e3)
        deflate_ms = max(0.0, (_deflate_wall_us() - deflate0) / 1e3)
        queue_ms = 0.0
        try:
            queue_ms = max(0.0, float(args.get("queue_wait_ms") or 0.0))
        except (TypeError, ValueError):
            pass
        # io is the unexplained remainder of the job wall: reader/writer
        # syscall waits, queue handoffs, pool joins.  Clamped at zero —
        # deflate runs in pool threads, so its wall can overlap (and on
        # many-core hosts exceed) the dispatcher-thread wall.
        io_ms = max(0.0, wall_ms - host_ms - device_ms - deflate_ms)
        # the span self-reports its decomposition (visible in traces and
        # flight dumps); setdefault so an explicit caller value wins
        args.setdefault("host_cpu_ms", round(host_ms, 3))
        args.setdefault("device_dispatch_ms", round(device_ms, 3))
        args.setdefault("deflate_ms", round(deflate_ms, 3))
        args.setdefault("queue_wait_ms", round(queue_ms, 3))
        with _lock:
            _attr["jobs"] += 1
            _attr["job_wall_ms"] += wall_ms
            _attr["queue_ms"] += queue_ms
            _attr["host_cpu_ms"] += host_ms
            _attr["device_dispatch_ms"] += device_ms
            _attr["deflate_ms"] += deflate_ms
            _attr["io_ms"] += io_ms


_OBSERVER = _Observer()


# --------------------------------------------------------------- sampler

def _format_stack(frame, limit: int = 48) -> list[str]:
    parts: list[str] = []
    while frame is not None and len(parts) < limit:
        code = frame.f_code
        mod = frame.f_globals.get("__name__") or \
            os.path.basename(code.co_filename)
        parts.append(f"{mod}.{code.co_name}")
        frame = frame.f_back
    parts.reverse()
    return parts


def _ingest(keys: list[str]) -> None:
    """Fold one tick's collapsed-stack keys into the bounded aggregate
    and the per-second flight window.  Split out from the sampler loop
    so tests drive drop accounting without real threads."""
    now_sec = int(time.time())
    cap = _max_stacks()
    with _lock:
        if not _window or _window[-1][0] != now_sec:
            _window.append((now_sec, {}))
        bucket = _window[-1][1]
        for key in keys:
            _tally["prof_samples"] += 1
            if key not in _agg and len(_agg) >= cap:
                _tally["prof_drops"] += 1
                continue
            _agg[key] = _agg.get(key, 0) + 1
            bucket[key] = bucket.get(key, 0) + 1


def _tick() -> None:
    own = threading.get_ident()
    frames = sys._current_frames()
    keys: list[str] = []
    with _lock:
        spans = {tid: stack[-1] for tid, stack in _span_stacks.items()
                 if stack}
    for tid, frame in frames.items():
        if tid == own:
            continue
        parts = _format_stack(frame)
        if not parts:
            continue
        span = spans.get(tid)
        if span is not None:
            parts.insert(0, f"span:{span}")
        keys.append(";".join(parts))
    del frames  # drop frame refs promptly
    if keys:
        _ingest(keys)


class _Sampler(threading.Thread):
    def __init__(self, hz: float):
        super().__init__(name="cct-prof-sampler", daemon=True)
        self.interval = 1.0 / hz
        self.stop_event = threading.Event()

    def run(self) -> None:
        last_flush = time.monotonic()
        while not self.stop_event.wait(self.interval):
            try:
                _tick()
            except Exception:
                pass  # the profiler must never take down the process
            now = time.monotonic()
            if now - last_flush >= _flush_s():
                last_flush = now
                try:
                    flush()
                except Exception:
                    pass


_sampler: _Sampler | None = None


def running() -> bool:
    s = _sampler
    return s is not None and s.is_alive()


def start(hz: float | None = None) -> bool:
    """Install the span observer and start the sampler thread.  Idempotent;
    returns True when this call started it."""
    global _sampler
    if running():
        return False
    _trace.set_observer(_OBSERVER)
    _sampler = _Sampler(hz if hz is not None else _hz())
    _sampler.start()
    return True


def maybe_start() -> bool:
    """Start iff ``CCT_PROF`` is truthy (the always-on entry point every
    daemon and CLI boot calls)."""
    if not enabled():
        return False
    return start()


def stop(timeout: float = 2.0) -> None:
    """Stop the sampler, flush the shard, uninstall the observer."""
    global _sampler
    s = _sampler
    _sampler = None
    if s is not None and s.is_alive():
        s.stop_event.set()
        s.join(timeout)
    _trace.set_observer(None)
    try:
        flush()
    except Exception:
        pass


def reset_for_tests() -> None:
    global _seq, _flushed_drops, _attr
    stop()
    with _lock:
        _span_stacks.clear()
        _agg.clear()
        _window.clear()
        _attr = _zero_attr()
        for k in _tally:
            _tally[k] = 0
        _seq = 0
        _flushed_drops = 0


# ------------------------------------------------------- shards + collect

def _shard_path() -> str | None:
    d = os.environ.get("CCT_PROF_DIR", "")
    if not d:
        return None
    return os.path.join(d, f"prof-{os.getpid()}.ndjson")


def _drain_locked() -> tuple[dict, dict, int]:
    """Under ``_lock``: take and reset the pending aggregate/attr/drops."""
    global _attr, _flushed_drops
    samples = dict(_agg)
    _agg.clear()
    attr = {k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in _attr.items()}
    _attr = _zero_attr()
    drops = _tally["prof_drops"] - _flushed_drops
    _flushed_drops = _tally["prof_drops"]
    return samples, attr, drops


def _line(samples: dict, attr: dict, drops: int, seq: int) -> dict:
    return {"v": 1, "pid": os.getpid(), "node": _trace.identity(),
            "seq": seq, "t": round(time.time(), 3),
            "samples": samples, "attr": attr, "drops": drops}


def flush() -> int:
    """Drain the pending aggregate as ONE NDJSON line onto this process's
    ``prof-<pid>.ndjson`` shard.  Returns the number of samples written
    (0 when ``CCT_PROF_DIR`` is unset or nothing is pending).  Single
    ``O_APPEND`` write — atomic per line under concurrent flushers."""
    global _seq
    path = _shard_path()
    if path is None:
        return 0
    with _lock:
        if not _agg and not any(_attr[k] for k in _ATTR_KEYS):
            return 0
        samples, attr, drops = _drain_locked()
        _seq += 1
        seq = _seq
        _tally["prof_shards"] += 1
    data = (json.dumps(_line(samples, attr, drops, seq), sort_keys=True)
            + "\n").encode("utf-8")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.write(fd, data)
    finally:
        os.close(fd)
    return sum(samples.values())


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


def collect(node: str | None = None) -> dict:
    """Everything this process knows, for the ``prof`` wire op: with a
    sink configured the pending aggregate is flushed and the shard read
    back (full durable history); without one, a single synthetic line
    from the live in-memory aggregate — NON-destructively, so repeated
    polls keep answering.  The synthetic line carries the seq a real
    flush would get: a later flush of the same data dedups against it
    by ``(pid, seq)`` at merge."""
    path = _shard_path()
    lines: list[dict] = []
    if path is not None:
        flush()
        lines = read_shard(path)
    else:
        with _lock:
            samples = dict(_agg)
            attr = {k: (round(v, 3) if isinstance(v, float) else v)
                    for k, v in _attr.items()}
            drops = _tally["prof_drops"] - _flushed_drops
            seq = _seq + 1
        if samples or any(attr[k] for k in _ATTR_KEYS):
            lines.append(_line(samples, attr, drops, seq))
    who = node or _trace.identity()
    for ln in lines:
        if who and not ln.get("node"):
            ln["node"] = who
    return {"node": who, "pid": os.getpid(), "lines": lines,
            "counters": counter_snapshot()}


def flight_snapshot(last_s: float = 30.0) -> dict:
    """Last-N-seconds collapsed stacks for flight-recorder dumps (what
    was it DOING, next to what happened).  Non-destructive."""
    cutoff = int(time.time() - last_s)
    merged: dict[str, int] = {}
    with _lock:
        for sec, bucket in _window:
            if sec < cutoff:
                continue
            for key, n in bucket.items():
                merged[key] = merged.get(key, 0) + n
    return {"window_s": last_s, "samples": merged}


# ------------------------------------------------------- merge + reports

def _line_total(ln: dict) -> int:
    return sum((ln.get("samples") or {}).values())


def merge_profiles(docs: list[dict]) -> dict:
    """Merge ``collect()`` replies / shard-line groups fleet-wide.

    Lines dedup by ``(pid, seq)``: a live process's wire reply and its
    on-disk shard overlap by design, and a live (synthetic) line may
    reappear later as a real flush with MORE counts — the max-sample
    version of each identity wins, then deduped lines sum."""
    best: dict[tuple, dict] = {}
    for doc in docs:
        for ln in (doc or {}).get("lines") or []:
            if not isinstance(ln, dict):
                continue
            key = (ln.get("pid"), ln.get("seq"))
            cur = best.get(key)
            if cur is None or _line_total(ln) > _line_total(cur):
                best[key] = ln
    samples: dict[str, int] = {}
    by_node: dict[str, dict] = {}
    drops = 0
    for ln in best.values():
        node = str(ln.get("node") or f"pid{ln.get('pid')}")
        slot = by_node.setdefault(
            node, {"samples": {}, "attr": _zero_attr(), "drops": 0})
        for key, n in (ln.get("samples") or {}).items():
            n = int(n)
            samples[key] = samples.get(key, 0) + n
            slot["samples"][key] = slot["samples"].get(key, 0) + n
        for k in _ATTR_KEYS:
            try:
                slot["attr"][k] += float((ln.get("attr") or {}).get(k) or 0)
            except (TypeError, ValueError):
                pass
        d = int(ln.get("drops") or 0)
        slot["drops"] += d
        drops += d
    return {"samples": samples, "by_node": by_node, "drops": drops,
            "lines": len(best)}


def top_functions(samples: dict, n: int = 20) -> list[tuple[str, int, int]]:
    """``(function, self_samples, cumulative_samples)`` rows, heaviest
    self first.  Self = leaf frame of each stack; cumulative counts each
    function once per stack it appears anywhere in."""
    self_n: dict[str, int] = {}
    cum_n: dict[str, int] = {}
    for key, count in samples.items():
        frames = [f for f in key.split(";") if not f.startswith("span:")]
        if not frames:
            continue
        self_n[frames[-1]] = self_n.get(frames[-1], 0) + count
        for fn in sorted(set(frames)):
            cum_n[fn] = cum_n.get(fn, 0) + count
    rows = [(fn, self_n.get(fn, 0), cum) for fn, cum in cum_n.items()]
    rows.sort(key=lambda r: (-r[1], -r[2], r[0]))
    return rows[:n]


def collapsed_lines(samples: dict) -> list[str]:
    """Standard collapsed-stack lines (``frame;frame count``) — feed
    straight into any flamegraph renderer."""
    return [f"{key} {count}" for key, count in
            sorted(samples.items(), key=lambda kv: (-kv[1], kv[0]))]


_BUCKETS = ("queue_ms", "routing_ms", "host_cpu_ms",
            "device_dispatch_ms", "deflate_ms", "io_ms")


def attribution_doc(merged: dict) -> dict:
    """Per-node + fleet wall decomposition from a ``merge_profiles``
    result: the six buckets in ms, their shares of the attributed total,
    and coverage = attributed / observed wall (observed = queue + job
    wall + routing; io is a remainder bucket so worker coverage is 1.0
    by construction — the number exists to PROVE nothing fell out)."""
    out: dict = {"nodes": {}, "fleet": {}}
    fleet = {k: 0.0 for k in _BUCKETS}
    fleet_wall = fleet_jobs = 0.0
    for node, slot in sorted((merged.get("by_node") or {}).items()):
        attr = slot.get("attr") or {}
        buckets = {k: round(float(attr.get(k) or 0.0), 3)
                   for k in _BUCKETS}
        attributed = sum(buckets.values())
        wall = (float(attr.get("queue_ms") or 0.0)
                + float(attr.get("job_wall_ms") or 0.0)
                + float(attr.get("routing_ms") or 0.0))
        shares = {k: round(v / attributed, 4) if attributed else 0.0
                  for k, v in buckets.items()}
        out["nodes"][node] = {
            "buckets_ms": buckets, "shares": shares,
            "wall_ms": round(wall, 3),
            "jobs": int(attr.get("jobs") or 0),
            "coverage": round(min(1.0, attributed / wall), 4)
            if wall else None,
        }
        for k in _BUCKETS:
            fleet[k] += buckets[k]
        fleet_wall += wall
        fleet_jobs += int(attr.get("jobs") or 0)
    attributed = sum(fleet.values())
    out["fleet"] = {
        "buckets_ms": {k: round(v, 3) for k, v in fleet.items()},
        "shares": {k: round(v / attributed, 4) if attributed else 0.0
                   for k, v in fleet.items()},
        "wall_ms": round(fleet_wall, 3), "jobs": int(fleet_jobs),
        "coverage": round(min(1.0, attributed / fleet_wall), 4)
        if fleet_wall else None,
    }
    return out


def render_report(merged: dict, top_n: int = 15) -> str:
    """Human report for ``cct prof report``: per-node hottest functions
    (self/cum) + the attribution table.  Pure; unit-tested."""
    lines: list[str] = []
    total = sum(merged.get("samples", {}).values())
    lines.append(f"cct prof — {total} samples over "
                 f"{len(merged.get('by_node') or {})} node(s), "
                 f"{merged.get('lines', 0)} shard line(s), "
                 f"{merged.get('drops', 0)} dropped stack key(s)")
    for node, slot in sorted((merged.get("by_node") or {}).items()):
        node_total = sum(slot["samples"].values())
        lines.append(f"\n{node}: {node_total} samples")
        rows = top_functions(slot["samples"], n=top_n)
        if rows:
            lines.append(f"  {'SELF%':>6} {'CUM%':>6} {'SELF':>6} "
                         f"{'CUM':>6}  FUNCTION")
            for fn, self_c, cum_c in rows:
                lines.append(
                    f"  {100.0 * self_c / node_total:>5.1f}% "
                    f"{100.0 * cum_c / node_total:>5.1f}% "
                    f"{self_c:>6} {cum_c:>6}  {fn}")
    attr = attribution_doc(merged)
    rows = list(attr["nodes"].items()) + [("FLEET", attr["fleet"])]
    if any(r[1]["wall_ms"] for r in rows):
        labels = {"queue_ms": "queue", "routing_ms": "route",
                  "host_cpu_ms": "host", "device_dispatch_ms": "dev",
                  "deflate_ms": "defl", "io_ms": "io"}
        lines.append("\nattribution (% of attributed wall):")
        lines.append(f"{'NODE':<12} {'JOBS':>5} {'WALL':>9} {'COV%':>5}  "
                     + "  ".join(f"{labels[k]:>5}" for k in _BUCKETS))
        for node, doc in rows:
            if not doc["wall_ms"]:
                continue
            shares = doc["shares"]
            cov = doc["coverage"]
            lines.append(
                f"{node:<12} {doc['jobs']:>5} "
                f"{doc['wall_ms'] / 1e3:>8.2f}s "
                f"{100.0 * cov if cov is not None else 0.0:>4.0f}%  "
                + "  ".join(f"{100.0 * shares[k]:>5.1f}"
                            for k in _BUCKETS))
    return "\n".join(lines) + "\n"


def top_panel(merged: dict) -> dict[str, dict]:
    """Per-node summary for ``cct top``'s prof panel: hottest function
    (by self samples) with its share, and queue wait as a share of job
    wall.  Pure over a ``merge_profiles`` result."""
    panel: dict[str, dict] = {}
    for node, slot in (merged.get("by_node") or {}).items():
        node_total = sum(slot["samples"].values())
        rows = top_functions(slot["samples"], n=1)
        attr = slot.get("attr") or {}
        wall = (float(attr.get("queue_ms") or 0.0)
                + float(attr.get("job_wall_ms") or 0.0))
        panel[node] = {
            "hot": rows[0][0] if rows else None,
            "hot_share": (rows[0][1] / node_total)
            if rows and node_total else 0.0,
            "queue_share": (float(attr.get("queue_ms") or 0.0) / wall)
            if wall else 0.0,
            "samples": node_total,
        }
    return panel


atexit.register(flush)
