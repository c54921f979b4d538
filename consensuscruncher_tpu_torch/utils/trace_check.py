#!/usr/bin/env python
"""Validate Chrome-trace exports — schema, and (fleet mode) causal
completeness across kills.

Port of the JAX package's ``tools/trace_check.py``: the same checks,
problem strings, summary and exit codes, run as ``python -m
consensuscruncher_tpu_torch.utils.trace_check``.  It reads files only (the
port's ``cct trace export`` / ``trace fleet`` output, ``CCT_TRACE_DIR``
shards, serve journals) and imports nothing but the standard library, so
it never opens a CUDA context.

Schema checks only need stdlib — no package imports — so the default
test suite and CI can assert "the trace a run exported will actually
load in Perfetto / chrome://tracing" without a browser:

- top level: ``{"traceEvents": [...]}`` (displayTimeUnit optional);
- every event: dict with string ``name``/``ph``, numeric ``ts`` and
  ``pid``/``tid``; ``X`` (complete) events need a numeric ``dur >= 0``,
  ``i`` (instant) events a scope ``s``; ``s``/``f`` flow arrows (the
  synthesized ``follows_from`` edges) need a numeric ``id``;
- span args carry the correlation ids the obs layer promises: an ``X``
  event with an ``args`` dict must include a ``trace_id``.

``check_trace(path)`` returns a list of human-readable problems (empty =
valid) for test use; the CLI exits 0/1 accordingly.

Fleet mode (``--fleet PATH --journals J...``) asserts the
**trace-completeness invariant** over a whole fleet run, including one
that chaos-killed processes mid-span:

1. *journal agreement* — every journal record carrying a given
   idempotency key names the SAME trace_id (a failover resubmit or
   adoption that minted a fresh trace instead of continuing the
   original would split the timeline);
2. *connectivity* — per trace_id, spans grouped by pid (one process =
   one lane) must form ONE component under ``follows_from`` edges.  A
   referenced pid with no surviving events — its ring died unflushed in
   a kill -9 — still unions the groups it is cited by (*virtual pid*):
   losing a parent span to a kill must not orphan the children that
   durably point at it.  Spans outside the root component (the one
   holding the minimum-hop span) are **orphans**;
3. *root presence* — a trace with events must contain a causal anchor
   span (``serve.submit``, or one of the HA continuations
   ``serve.replay`` / ``route.resubmit`` / ``route.adopt_job`` whose
   link proves the original anchor existed);
4. *terminal presence* — a key whose journal proves it terminal must
   have a ``serve.terminal`` trace event (the scheduler flushes that
   event BEFORE the terminal journal append, so journal-terminal
   implies trace-terminal even under kill -9 right after the fsync).

``PATH`` may be a merged Chrome-trace JSON (``cct trace fleet`` output)
or a ``CCT_TRACE_DIR`` shard directory.  ``check_fleet`` is importable
(``utils/chaos_conductor.py`` calls it per event); the CLI exits 0/1.

  python -m consensuscruncher_tpu_torch.utils.trace_check TRACE.json
  python -m consensuscruncher_tpu_torch.utils.trace_check --fleet MERGED.json \\
      --journals w0.journal w1.journal
"""

from __future__ import annotations

import glob
import json
import os
import sys

_REQUIRED_PHASES = {"X", "i", "B", "E", "M", "s", "f"}

#: Span names that anchor a job's causal tree: the submit ack itself, or
#: an HA continuation that durably links back to it.
_ANCHOR_SPANS = ("serve.submit", "serve.replay", "route.resubmit",
                 "route.adopt_job")


def _check_event(i: int, ev: object, problems: list[str]) -> None:
    where = f"traceEvents[{i}]"
    if not isinstance(ev, dict):
        problems.append(f"{where}: not an object")
        return
    for key in ("name", "ph"):
        if not isinstance(ev.get(key), str) or not ev.get(key):
            problems.append(f"{where}: missing/non-string '{key}'")
    for key in ("ts", "pid", "tid"):
        if not isinstance(ev.get(key), (int, float)) or \
                isinstance(ev.get(key), bool):
            problems.append(f"{where}: missing/non-numeric '{key}'")
    ph = ev.get("ph")
    if isinstance(ph, str) and ph not in _REQUIRED_PHASES:
        problems.append(f"{where}: unknown phase {ph!r}")
    if ph == "X":
        dur = ev.get("dur")
        if not isinstance(dur, (int, float)) or isinstance(dur, bool) \
                or dur < 0:
            problems.append(f"{where}: 'X' event needs numeric dur >= 0")
        args = ev.get("args")
        if isinstance(args, dict) and "trace_id" not in args:
            problems.append(f"{where}: span args carry no trace_id")
    if ph == "i" and not isinstance(ev.get("s"), str):
        problems.append(f"{where}: 'i' event needs a scope 's'")
    if ph in ("s", "f") and not isinstance(ev.get("id"), (int, str)):
        problems.append(f"{where}: flow event needs an 'id'")


def check_trace(path: str) -> list[str]:
    """Return a list of schema problems with the trace at ``path``
    (empty list = loads fine in Perfetto/chrome://tracing)."""
    events, problems = _load_events(path)
    if problems:
        return problems
    for i, ev in enumerate(events):
        _check_event(i, ev, problems)
        if len(problems) >= 50:
            problems.append("... (truncated after 50 problems)")
            break
    return problems


# --------------------------------------------------------------- loading

def _load_events(path: str) -> tuple[list[dict], list[str]]:
    """Events from a merged Chrome-trace JSON, a bare event array, or a
    shard DIRECTORY of ``trace-*.ndjson`` files (one line per event)."""
    if os.path.isdir(path):
        events: list[dict] = []
        for shard in sorted(glob.glob(os.path.join(path,
                                                   "trace-*.ndjson"))):
            try:
                with open(shard, "r", encoding="utf-8") as fh:
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
            except OSError:
                continue
        return events, []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except OSError as e:
        return [], [f"unreadable: {e}"]
    except ValueError as e:
        return [], [f"not JSON: {e}"]
    if isinstance(doc, list):
        return doc, []  # the array form is legal Chrome-trace too
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return [], ["top-level object has no 'traceEvents' array"]
        return events, []
    return [], ["top level is neither an object nor an event array"]


def journal_trace_ids(paths: list[str]) -> dict[str, dict]:
    """Per-idempotency-key trace facts from a set of serve journals:
    ``{key: {"trace_ids": set, "terminal": bool, "journals": set}}``.
    Tolerant NDJSON replay (merge by id per journal, later fields win;
    torn/corrupt lines skipped) — stdlib only, mirroring the daemon's
    own replay semantics."""
    out: dict[str, dict] = {}
    for path in paths:
        merged: dict[int, dict] = {}
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError:
            continue
        for line in raw.split(b"\n"):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict) or rec.get("rec") != "job":
                continue
            try:
                jid = int(rec["id"])
            except (KeyError, TypeError, ValueError):
                continue
            merged.setdefault(jid, {}).update(
                {k: v for k, v in rec.items() if k not in ("v", "rec")})
        for rec in merged.values():
            key = rec.get("key")
            if not key:
                continue
            info = out.setdefault(str(key), {"trace_ids": set(),
                                             "terminal": False,
                                             "journals": set()})
            if rec.get("trace_id"):
                info["trace_ids"].add(str(rec["trace_id"]))
            if rec.get("state") in ("done", "failed"):
                info["terminal"] = True
            info["journals"].add(os.path.basename(path))
    return out


# ---------------------------------------------------------- fleet check

class _Union:
    """Tiny union-find over hashable nodes (pid groups, virtual pids)."""

    def __init__(self):
        self.parent: dict = {}

    def find(self, x):
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def _trace_components(events: list[dict]) -> dict[str, dict]:
    """Group every X span and i event by trace_id and compute pid-group
    connectivity.  Returns per trace_id::

        {"spans": [...], "events": [...], "orphans": [...],
         "names": set, "event_names": set}

    Connectivity is over pid groups: spans sharing a pid are one group
    (same process — thread-crossing inside a process needs no explicit
    edge); ``follows_from`` edges union groups across pids, including
    *virtual* pids with no surviving events (killed before flush)."""
    traces: dict[str, dict] = {}
    for ev in events:
        if ev.get("ph") not in ("X", "i"):
            continue
        args = ev.get("args")
        tid = (args or {}).get("trace_id") if isinstance(args, dict) \
            else None
        if not tid:
            continue
        t = traces.setdefault(str(tid), {"spans": [], "events": [],
                                         "names": set(),
                                         "event_names": set()})
        if ev.get("ph") == "X":
            t["spans"].append(ev)
            t["names"].add(ev.get("name"))
        else:
            t["events"].append(ev)
            t["event_names"].add(ev.get("name"))
    for t in traces.values():
        uf = _Union()
        pids = set()
        for ev in t["spans"] + t["events"]:
            pid = ev.get("pid")
            pids.add(pid)
            uf.find(pid)
            ff = (ev.get("args") or {}).get("follows_from")
            if isinstance(ff, dict) and ff.get("pid") is not None:
                # virtual-pid union: the cited process may have died
                # with its ring unflushed; the durable citation still
                # proves the causal connection
                uf.union(pid, ff["pid"])
        root_ev = min(
            t["spans"] + t["events"],
            key=lambda ev: ((ev.get("args") or {}).get("hop", 0),
                            ev.get("ts", 0)),
            default=None)
        root = uf.find(root_ev.get("pid")) if root_ev is not None else None
        t["orphans"] = [ev for ev in t["spans"]
                        if uf.find(ev.get("pid")) != root]
        t["components"] = len({uf.find(p) for p in pids}) if pids else 0
    return traces


def check_fleet(trace_path: str,
                journal_paths: list[str] | None = None) -> list[str]:
    """The fleet trace-completeness invariant; returns problems (empty =
    every acked job's span tree is connected, anchored, and terminated
    in agreement with the journals)."""
    events, problems = _load_events(trace_path)
    if problems:
        return problems
    spans_total = sum(1 for ev in events if ev.get("ph") == "X")
    if spans_total == 0:
        return ["no spans in the trace — was the fleet run with "
                "CCT_TRACE=1 (and CCT_TRACE_DIR for kill durability)?"]
    traces = _trace_components(events)
    keys = journal_trace_ids(journal_paths or [])
    journal_tids = {tid for info in keys.values()
                    for tid in info["trace_ids"]}
    for tid in sorted(traces):
        t = traces[tid]
        if not t["spans"]:
            continue
        for ev in t["orphans"][:10]:
            problems.append(
                f"trace {tid}: ORPHANED span '{ev.get('name')}' "
                f"(pid {ev.get('pid')}) — disconnected from the root "
                f"component ({t['components']} components)")
        # the anchor requirement applies to JOB traces only — journal-
        # cited, or carrying worker-side serve.* activity.  Background
        # traces (health probes, metrics forwards, marker appends) are
        # legitimately anchorless singletons.
        is_job = tid in journal_tids or \
            any(n and n.startswith("serve.") for n in t["names"])
        if is_job and not (t["names"] & set(_ANCHOR_SPANS)):
            problems.append(
                f"trace {tid}: no causal anchor span "
                f"(expected one of {', '.join(_ANCHOR_SPANS)}; "
                f"got {sorted(n for n in t['names'] if n)})")
    for key in sorted(keys):
        info = keys[key]
        tids = info["trace_ids"]
        if len(tids) > 1:
            problems.append(
                f"key {key}: journals disagree on trace_id "
                f"({sorted(tids)} across {sorted(info['journals'])}) — "
                "an HA hand-off minted a fresh trace instead of "
                "continuing the original")
        if info["terminal"] and len(tids) == 1:
            tid = next(iter(tids))
            t = traces.get(tid)
            if t is None:
                problems.append(
                    f"key {key}: journal proves terminal but trace "
                    f"{tid} has no events at all (terminal-before-"
                    "append ordering violated, or shards lost)")
            elif "serve.terminal" not in t["event_names"] \
                    and "route.journal_answer" not in t["names"]:
                problems.append(
                    f"key {key}: journal proves terminal but trace "
                    f"{tid} carries no serve.terminal event")
    return problems


def fleet_summary(trace_path: str,
                  journal_paths: list[str] | None = None) -> dict:
    """Machine-readable companion to :func:`check_fleet` (tests and the
    chaos conductor read counts, not strings)."""
    events, problems = _load_events(trace_path)
    traces = _trace_components(events) if not problems else {}
    keys = journal_trace_ids(journal_paths or [])
    return {
        "events": len(events),
        "spans": sum(len(t["spans"]) for t in traces.values()),
        "traces": len(traces),
        "orphans": sum(len(t["orphans"]) for t in traces.values()),
        "keys": len(keys),
        "terminal_keys": sum(1 for i in keys.values() if i["terminal"]),
        "problems": check_fleet(trace_path, journal_paths),
    }


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--fleet":
        if len(argv) < 2:
            print("usage: trace_check.py --fleet TRACE_OR_SHARD_DIR "
                  "[--journals J1 J2 ...]", file=sys.stderr)
            return 2
        path = argv[1]
        journals: list[str] = []
        if "--journals" in argv:
            journals = argv[argv.index("--journals") + 1:]
        summary = fleet_summary(path, journals)
        for p in summary["problems"]:
            print(f"{path}: {p}")
        print(f"{path}: fleet check — {summary['spans']} spans in "
              f"{summary['traces']} traces, {summary['orphans']} "
              f"orphan(s), {summary['terminal_keys']}/{summary['keys']} "
              f"journal keys terminal, "
              f"{len(summary['problems'])} problem(s)")
        return 1 if summary["problems"] else 0
    if not argv:
        print("usage: trace_check.py TRACE.json [TRACE2.json ...]\n"
              "       trace_check.py --fleet TRACE_OR_SHARD_DIR "
              "[--journals J1 J2 ...]", file=sys.stderr)
        return 2
    rc = 0
    for path in argv:
        problems = check_trace(path)
        if problems:
            rc = 1
            for p in problems:
                print(f"{path}: {p}")
        else:
            print(f"{path}: ok")
    return rc


if __name__ == "__main__":
    sys.exit(main())
