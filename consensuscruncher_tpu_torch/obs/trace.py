"""Correlation-id spans buffered in per-thread rings (Chrome-trace out).

Design constraints, in priority order:

1. **Zero-cost when off.**  ``span()`` returns one shared no-op context
   manager when ``CCT_TRACE`` is unset — no allocation, no clock read.
   The enabled flag is cached against the raw env string and re-checked
   only when the string changes (same trick as ``faults.get``), so tests
   can flip it with ``monkeypatch.setenv``.
2. **Lock-free-ish hot path.**  Each thread appends finished spans to
   its own ring (a plain list owned by the thread); the only global lock
   guards thread-state registration and span-id minting.  ``flush()``
   swaps rings out and appends all lines with a single ``os.write`` on
   an ``O_APPEND`` descriptor — atomic per write on POSIX, so shards
   from concurrent flushes interleave at line granularity, never inside
   a line.
3. **Determinism firewall.**  Spans only ever land in sidecar files
   (``trace-<pid>.ndjson`` under ``$CCT_TRACE_DIR``); nothing here
   touches pipeline outputs, so golden digests cannot be perturbed.
   Trace ids come from ``os.urandom`` (not ``random``) so enabling
   tracing never advances any seeded RNG stream.

Span parenting rides a per-thread stack: a span with no explicit
``trace_id`` inherits the enclosing span's, and mints a fresh one at the
root — so a one-shot CLI run gets its id at ``cli.<command>`` while a
serve worker inherits the id minted at ``submit``.

Cross-PROCESS causality rides wire trace contexts: ``wire_context()``
snapshots the innermost open span as ``{"trace_id", "span", "pid",
"hop"}`` (span ids are process-local ints, so ``pid`` is part of the
address; ``hop`` counts wire crossings), the serve client stamps it on
outbound NDJSON requests, and the receiver opens its span with
``link=ctx`` — adopting the trace id and hop and recording a
``follows_from`` edge back to the sender's span.  ``merge_fleet_trace``
/ ``export_chrome_trace`` later turn those edges into Chrome-trace flow
arrows (``ph: s``/``f``) so Perfetto draws the hop.

Wall/monotonic split: ``ts`` is epoch microseconds at span start (what
Perfetto aligns across processes and against ``maybe_profile``'s torch.profiler
timeline) while ``dur`` is measured with ``perf_counter`` so NTP steps
cannot produce negative spans.
"""

from __future__ import annotations

import atexit
import binascii
import glob
import json
import os
import threading
import time

from consensuscruncher_tpu_torch.obs import metrics as _metrics

_TRUE_WORDS = ("1", "true", "on", "yes")

# (raw env string, parsed flag) — compare the raw string so setenv in
# tests invalidates the cache without an explicit reset hook.
_env_cache: tuple[str, bool] = ("\x00unset", False)


def enabled() -> bool:
    global _env_cache
    raw = os.environ.get("CCT_TRACE", "")
    if raw != _env_cache[0]:
        _env_cache = (raw, raw.strip().lower() in _TRUE_WORDS)
    return _env_cache[1]


def _ring_cap() -> int:
    try:
        return max(64, int(os.environ.get("CCT_TRACE_RING", "4096")))
    except ValueError:
        return 4096


def mint_trace_id() -> str:
    return binascii.hexlify(os.urandom(8)).decode("ascii")


class _ThreadState:
    __slots__ = ("events", "stack")

    def __init__(self):
        self.events: list[dict] = []
        # (trace_id, span_id, hop) of each open span, innermost last
        self.stack: list[tuple[str | None, int, int]] = []


_tls = threading.local()
_states: list[_ThreadState] = []
_state_lock = threading.Lock()
_next_span_id = 0

# fleet node identity stamped onto every recorded event (serve --node /
# route --router_id), so merged fleet traces can name a dead process's
# shard-only lane; None outside a fleet daemon.
_identity: str | None = None

# span observer installed by obs.prof: rides every _Span enter/exit so
# the sampler can attribute stacks to the innermost open span and job
# spans can self-report wall attribution — even with CCT_TRACE off
# (span() constructs a real _Span whenever an observer is live).
_observer = None

# process-wide trace-plane tallies, folded into the scheduler/router
# metrics docs (names registered in obs/registry.py COUNTERS).  Plain
# ints under _state_lock: the span hot path already takes that lock to
# mint ids.
_tally = {"trace_spans_emitted": 0, "trace_links": 0, "trace_orphans": 0}


def set_identity(node: str | None) -> None:
    """Stamp ``node`` onto every event this process records from now on."""
    global _identity
    _identity = str(node) if node else None


def identity() -> str | None:
    """The fleet node identity this process stamps (None outside a
    daemon) — shared with the profiler's shard lines."""
    return _identity


def set_observer(obs) -> None:
    """Install (or with None, remove) the span observer — an object with
    ``span_enter(name) -> token`` and ``span_exit(name, token, args,
    dur_s)``.  Observer failures are swallowed at the call sites: the
    profiler must never take down a job."""
    global _observer
    _observer = obs


def counter_snapshot() -> dict:
    """Current trace-plane tallies, keyed like registry COUNTERS."""
    with _state_lock:
        return dict(_tally)


def note_orphan(n: int = 1) -> None:
    """Count an HA continuation point that had no trace context to link
    from (the causal chain is severed at this hop)."""
    with _state_lock:
        _tally["trace_orphans"] += n


def _state() -> _ThreadState:
    st = getattr(_tls, "st", None)
    if st is None:
        st = _ThreadState()
        _tls.st = st
        with _state_lock:
            _states.append(st)
    return st


def _mint_span_id() -> int:
    global _next_span_id
    with _state_lock:
        _next_span_id += 1
        return _next_span_id


def _record(st: _ThreadState, ev: dict) -> None:
    if _identity is not None:
        ev.setdefault("node", _identity)
    with _state_lock:
        _tally["trace_spans_emitted"] += 1
    st.events.append(ev)
    if len(st.events) >= _ring_cap():
        if _shard_path() is not None:
            flush()
        else:
            # no sink configured: bounded ring, drop the oldest half
            del st.events[: len(st.events) // 2]


def current_trace_id() -> str | None:
    st = getattr(_tls, "st", None)
    if st is None or not st.stack:
        return None
    return st.stack[-1][0]


def wire_context() -> dict | None:
    """Trace context for an outbound NDJSON message: the innermost open
    span on this thread as ``{"trace_id", "span", "pid", "hop"}`` with
    the hop count pre-incremented for the crossing.  None when tracing
    is off or no span is open — callers just omit the field then."""
    if not enabled():
        return None
    st = getattr(_tls, "st", None)
    if st is None or not st.stack:
        return None
    trace_id, span_id, hop = st.stack[-1]
    if trace_id is None:
        return None
    return {"trace_id": trace_id, "span": span_id, "pid": os.getpid(),
            "hop": hop + 1}


class _Noop:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def note(self, **args):
        """Accept late span args on the disabled path too."""


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "trace_id", "histogram", "args", "link",
                 "_recording", "_span_id", "_parent_id", "_hop",
                 "_t0", "_w0", "_prof")

    def __init__(self, name, trace_id, histogram, args, link=None):
        self.name = name
        self.trace_id = trace_id
        self.histogram = histogram
        self.args = args
        self.link = link if isinstance(link, dict) else None

    def note(self, **args):
        """Attach args decided mid-span (route target, steal verdict)."""
        self.args.update(args)

    def __enter__(self):
        self._recording = enabled()
        if self._recording:
            st = _state()
            parent = st.stack[-1] if st.stack else None
            link = self.link
            if self.trace_id is None:
                if link is not None and link.get("trace_id"):
                    self.trace_id = link["trace_id"]
                else:
                    self.trace_id = parent[0] if parent else mint_trace_id()
            if link is not None:
                hop = link.get("hop")
                self._hop = int(hop) if isinstance(hop, int) else 0
            else:
                self._hop = parent[2] if parent else 0
            self._span_id = _mint_span_id()
            self._parent_id = parent[1] if parent else None
            st.stack.append((self.trace_id, self._span_id, self._hop))
        obs = _observer
        self._prof = None
        if obs is not None:
            try:
                self._prof = obs.span_enter(self.name)
            except Exception:
                pass  # the profiler must never take down a job
        self._w0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        if self.histogram is not None:
            _metrics.observe(self.histogram, dur)
        obs = _observer
        if obs is not None:
            # before the event is recorded, so observer-computed span
            # args (host_cpu_ms & friends on serve.job) land in it
            try:
                obs.span_exit(self.name, self._prof, self.args, dur)
            except Exception:
                pass
        if self._recording:
            st = _state()
            if st.stack:
                st.stack.pop()
            args = {"trace_id": self.trace_id, "hop": self._hop}
            if self._parent_id is not None:
                args["parent"] = self._parent_id
            link = self.link
            if link is not None and link.get("span") is not None \
                    and link.get("pid") is not None:
                args["follows_from"] = {"span": link["span"],
                                        "pid": link["pid"]}
                with _state_lock:
                    _tally["trace_links"] += 1
            if exc_type is not None:
                args["error"] = exc_type.__name__
            args.update(self.args)
            _record(st, {
                "name": self.name, "cat": "cct", "ph": "X",
                "ts": int(self._w0 * 1e6), "dur": max(1, int(dur * 1e6)),
                "pid": os.getpid(), "tid": threading.get_ident(),
                "id": self._span_id, "args": args,
            })
        return False


def span(name: str, trace_id: str | None = None,
         histogram: str | None = None, link: dict | None = None, **args):
    """Context manager timing ``name``.

    ``histogram`` names a registered histogram that the duration is
    always observed into, even with tracing disabled (histograms are
    part of the metrics endpoint, not the trace).  Without one, the
    disabled path returns a shared no-op object.

    ``link`` is an inbound wire trace context (see :func:`wire_context`):
    the span adopts its trace id (unless ``trace_id`` overrides) and hop
    count and records a ``follows_from`` edge back to the sender's span —
    the cross-process continuation primitive every HA hand-off uses.
    """
    if not enabled() and histogram is None and _observer is None:
        return _NOOP
    return _Span(name, trace_id, histogram, args, link=link)


def event(name: str, trace_id: str | None = None, **args) -> None:
    """Record an instant event (Chrome-trace ``ph: i``), parented to the
    innermost open span on this thread."""
    if not enabled():
        return
    st = _state()
    parent = st.stack[-1] if st.stack else None
    a: dict = {}
    tid = trace_id if trace_id is not None else (parent[0] if parent else None)
    if tid is not None:
        a["trace_id"] = tid
    if parent is not None:
        a["parent"] = parent[1]
        a["hop"] = parent[2]
    a.update(args)
    _record(st, {
        "name": name, "cat": "cct", "ph": "i", "s": "t",
        "ts": int(time.time() * 1e6),
        "pid": os.getpid(), "tid": threading.get_ident(), "args": a,
    })


def _shard_path() -> str | None:
    d = os.environ.get("CCT_TRACE_DIR", "")
    if not d:
        return None
    return os.path.join(d, f"trace-{os.getpid()}.ndjson")


def _grab_all() -> list[dict]:
    grabbed: list[list[dict]] = []
    with _state_lock:
        for st in _states:
            if st.events:
                grabbed.append(st.events)
                st.events = []
    return [ev for ring in grabbed for ev in ring]


def flush() -> int:
    """Drain every thread ring into this process's NDJSON shard.

    Returns the number of events written (0 when ``CCT_TRACE_DIR`` is
    unset — events then stay in the bounded in-memory rings).  The write
    happens outside all locks: a single ``os.write`` to an ``O_APPEND``
    fd keeps whole lines atomic under concurrent flushers.
    """
    path = _shard_path()
    if path is None:
        return 0
    events = _grab_all()
    if not events:
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = "".join(
        json.dumps(ev, sort_keys=True) + "\n" for ev in events
    ).encode("utf-8")
    fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.write(fd, data)
    finally:
        os.close(fd)
    return len(events)


def drain_events() -> list[dict]:
    """Remove and return all buffered events (test hook; no file IO)."""
    return _grab_all()


def recent_events(limit: int = 256) -> list[dict]:
    """Non-destructive snapshot of the newest buffered events, oldest
    first (feeds flight-recorder dumps without stealing the shard's)."""
    with _state_lock:
        snap = [ev for st in _states for ev in st.events]
    snap.sort(key=lambda ev: ev.get("ts", 0))
    return snap[-limit:]


def _read_shard(path: str) -> list[dict]:
    events: list[dict] = []
    try:
        fh = open(path, "r", encoding="utf-8")
    except OSError:
        return events
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue  # torn by a kill: skip, never fatal
            if isinstance(ev, dict):
                events.append(ev)
    return events


def collect_events(limit: int = 100000) -> list[dict]:
    """Everything this process knows about, for the ``trace`` wire op:
    with a sink configured the rings are flushed and the shard read back
    (full durable history); without one, the bounded in-memory rings."""
    path = _shard_path()
    if path is None:
        return recent_events(limit=limit)
    flush()
    return _read_shard(path)[-limit:]


def _flow_events(events: list[dict]) -> list[dict]:
    """Synthesize Chrome-trace flow arrows (``ph: s``/``f``) from the
    ``follows_from`` edges recorded by linked spans.  An edge whose
    source span never made it to disk (killed before flush) simply draws
    no arrow — the span args still carry the link for
    ``utils/trace_check.py --fleet``."""
    by_span = {(ev.get("pid"), ev.get("id")): ev
               for ev in events if ev.get("ph") == "X"}
    flows: list[dict] = []
    flow_id = 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        ff = (ev.get("args") or {}).get("follows_from")
        if not isinstance(ff, dict):
            continue
        src = by_span.get((ff.get("pid"), ff.get("span")))
        if src is None:
            continue
        flow_id += 1
        head = {"name": "trace_link", "cat": "cct", "id": flow_id}
        flows.append({**head, "ph": "s",
                      "ts": src["ts"] + max(0, src.get("dur", 1) - 1),
                      "pid": src["pid"], "tid": src["tid"]})
        flows.append({**head, "ph": "f", "bp": "e", "ts": ev["ts"],
                      "pid": ev["pid"], "tid": ev["tid"]})
    return flows


def _write_chrome_trace(events: list[dict], out_path: str) -> int:
    events.extend(_flow_events(events))
    # name each pid lane after the fleet identity its events carry, so
    # Perfetto shows "w0" / "router r0" instead of bare pids
    lanes: dict[int, str] = {}
    for ev in events:
        node = ev.get("node")
        if node and ev.get("pid") is not None:
            lanes.setdefault(ev["pid"], str(node))
    for pid in sorted(lanes):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "ts": 0, "cat": "cct",
                       "args": {"name": lanes[pid]}})
    events.sort(key=lambda ev: (ev.get("ts", 0), ev.get("pid", 0)))
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, sort_keys=True)
        fh.write("\n")
    return len(events)


def merge_fleet_trace(groups: list[list[dict]], out_path: str) -> int:
    """Merge per-node event lists (wire-pulled buffers, local shards)
    into one Chrome-trace timeline at ``out_path``: exact-duplicate
    events collapse (a node's wire buffer and its shard overlap by
    design), ``follows_from`` edges become cross-lane flow arrows, and
    pid lanes are named from the events' ``node`` stamps.  Returns the
    merged event count."""
    seen: set[str] = set()
    events: list[dict] = []
    for group in groups:
        for ev in group or []:
            if not isinstance(ev, dict):
                continue
            key = json.dumps(ev, sort_keys=True)
            if key in seen:
                continue
            seen.add(key)
            events.append(ev)
    return _write_chrome_trace(events, out_path)


def export_chrome_trace(trace_dir: str, out_path: str) -> int:
    """Merge ``trace-*.ndjson`` shards under ``trace_dir`` into a single
    Chrome-trace JSON at ``out_path``; returns the event count.

    The output loads directly in Perfetto / ``chrome://tracing`` and can
    sit beside ``maybe_profile``'s torch.profiler trace.
    Corrupt lines (torn by a kill) are skipped, not fatal.
    """
    if _shard_path() is not None:
        flush()
    events: list[dict] = []
    for path in sorted(glob.glob(os.path.join(trace_dir, "trace-*.ndjson"))):
        events.extend(_read_shard(path))
    return _write_chrome_trace(events, out_path)


atexit.register(flush)
