"""Per-job critical-path decomposition from scheduler boundary stamps.

The profiler's attribution (obs/prof.py) answers "where does the
fleet's wall go" in aggregate; this module answers it *causally, per
job*: every finished job's submit->terminal wall is reconstructed into
an ordered segment chain (admit -> journal-ack -> queue -> gang-form ->
handoff -> run, the run further split device/deflate/host where the
profiler's span deltas are available) from the ``serve.critpath``
instant events the scheduler emits at every terminal transition — done,
failed, shed, and quarantined alike, so rejected work is accounted too.

The stamps telescope: consecutive boundaries partition the wall exactly,
so segment-sum coverage is ~1.0 by construction and the ci gate's >=95%
floor catches a scheduler path that forgot to stamp.  Each queue segment
carries an *antagonist* — who made the job wait: the dispatcher (busy on
named jobs), a named lock (from the CCT_LOCK_LEDGER contention ledger,
holder thread included), or admission idle.  Everything here is pure
math over collected trace events; collection itself rides the existing
``trace`` wire op / ``CCT_TRACE_DIR`` shards.

Port of ``consensuscruncher_tpu/obs/critpath.py``, line for line: it
reads the ``serve.critpath`` event the port's ``serve/scheduler.py``
emits (the same stamps, ``Scheduler._CRITPATH_ORDER``).  Pure math; it
imports nothing of torch.
"""

from __future__ import annotations

import json

#: boundary stamp order on the serve.critpath event (ms from submit)
STAMP_ORDER = ("submit", "admit", "journal", "ack", "gang", "dispatch",
               "run")

#: segment named by its RIGHT boundary stamp; the tail segment (last
#: stamp -> terminal) takes the name the next boundary WOULD have had,
#: so a job shed while queued reports its wait as "queue", not "run"
_SEG_FOR = {"admit": "admit", "journal": "journal", "ack": "ack",
            "gang": "queue", "dispatch": "gang_form", "run": "handoff"}
_TAIL_FOR = {"submit": "admit", "admit": "journal", "journal": "ack",
             "ack": "queue", "gang": "gang_form", "dispatch": "handoff",
             "run": "run"}

#: canonical rendering order for the fleet table
SEGMENT_ORDER = ("admit", "journal", "ack", "queue", "gang_form",
                 "handoff", "run")


def critpath_events(events: list[dict]) -> list[dict]:
    """The ``serve.critpath`` instants from a raw event list, exact
    duplicates collapsed (a node's wire buffer and its shard overlap by
    design, exactly like the fleet trace merge)."""
    seen: set[tuple] = set()
    out: list[dict] = []
    for ev in events or []:
        if not isinstance(ev, dict) or ev.get("name") != "serve.critpath":
            continue
        a = ev.get("args") or {}
        key = (ev.get("pid"), a.get("job_id"), a.get("state"),
               ev.get("ts"))
        if key in seen:
            continue
        seen.add(key)
        out.append(ev)
    return out


def _job_spans(events: list[dict]) -> dict[tuple, dict]:
    """(pid, job_id) -> serve.job span args, for the run-phase split."""
    spans: dict[tuple, dict] = {}
    for ev in events or []:
        if not isinstance(ev, dict) or ev.get("name") != "serve.job" \
                or ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        if args.get("job_id") is not None:
            spans[(ev.get("pid"), args["job_id"])] = args
    return spans


def decompose(ev: dict, job_args: dict | None = None) -> dict:
    """One job's ordered segment chain from its serve.critpath event.

    Segments are the diffs of consecutive present stamps plus the tail
    (last stamp -> terminal); they telescope, so ``coverage`` — segment
    sum over the wall — is ~1.0 whenever the scheduler stamped every
    boundary it crossed.  ``job_args`` (the job's serve.job span args)
    optionally splits the run segment into device/deflate/host/other
    using the profiler's self-reported deltas."""
    a = ev.get("args") or {}
    stamps = a.get("stamps") or {}
    wall = max(0.0, float(a.get("wall_ms") or 0.0))
    present = [(name, float(stamps[name])) for name in STAMP_ORDER
               if name in stamps]
    segments: list[dict] = []
    for (prev_name, prev_t), (name, t) in zip(present, present[1:]):
        segments.append({"name": _SEG_FOR[name],
                         "ms": round(max(0.0, t - prev_t), 3)})
    if present:
        last_name, last_t = present[-1]
        tail = {"name": _TAIL_FOR[last_name],
                "ms": round(max(0.0, wall - last_t), 3)}
        if tail["name"] == "run" and job_args:
            split = {}
            for src, dst in (("device_dispatch_ms", "device"),
                             ("deflate_ms", "deflate"),
                             ("host_cpu_ms", "host")):
                try:
                    v = float(job_args.get(src) or 0.0)
                except (TypeError, ValueError):
                    v = 0.0
                if v > 0:
                    split[dst] = round(v, 3)
            if split:
                # the phases overlap threads (deflate runs in a pool), so
                # this is attribution, not a partition — "other" is
                # clamped at zero like prof's io bucket
                split["other"] = round(
                    max(0.0, tail["ms"] - sum(split.values())), 3)
                tail["split"] = split
        segments.append(tail)
    total = sum(s["ms"] for s in segments)
    return {
        "job_id": a.get("job_id"), "key": a.get("key"),
        "state": a.get("state"), "tenant": a.get("tenant"),
        "qos": a.get("qos"), "node": ev.get("node"),
        "pid": ev.get("pid"), "cached": bool(a.get("cached")),
        "gang_size": a.get("gang_size"),
        "wall_ms": round(wall, 3),
        "queue_wait_ms": float(a.get("queue_wait_ms") or 0.0),
        "segments": segments,
        "coverage": round(min(1.0, total / wall), 4) if wall else None,
        "antagonist": a.get("antagonist") or {},
    }


def from_events(events: list[dict]) -> list[dict]:
    """Every job's decomposition from a raw (possibly fleet-merged)
    event list."""
    spans = _job_spans(events)
    return [decompose(ev, spans.get(((ev.get("pid")),
                                     (ev.get("args") or {}).get("job_id"))))
            for ev in critpath_events(events)]


def antagonist_label(ant: dict) -> str:
    """The fleet-table key for one job's antagonist: concrete — the
    lock's name, not just "a lock"."""
    kind = (ant or {}).get("kind") or "unknown"
    if kind == "lock" and ant.get("lock"):
        label = f"lock:{ant['lock']}"
        if ant.get("lock_holder"):
            label += f" (held by {ant['lock_holder']})"
        return label
    if kind == "dispatcher":
        jobs = ant.get("busy_on_jobs") or []
        if jobs:
            shown = ",".join(str(j) for j in jobs[:4])
            return f"dispatcher busy (jobs {shown})"
        return "dispatcher busy"
    if kind == "idle":
        return "admission idle"
    return kind


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def fleet_report(jobs: list[dict]) -> dict:
    """The "where does p99 queue time actually go" table: per-segment
    totals and percentiles across every decomposed job, plus the queue
    antagonist table (label -> blamed queue ms + job count) and the
    dominant antagonist of the dominant queue segment."""
    by_seg: dict[str, list[float]] = {}
    for job in jobs:
        for seg in job.get("segments") or []:
            by_seg.setdefault(seg["name"], []).append(float(seg["ms"]))
    total_all = sum(sum(v) for v in by_seg.values()) or 1.0
    seg_table = {}
    for name, vals in by_seg.items():
        vals = sorted(vals)
        seg_table[name] = {
            "jobs": len(vals), "total_ms": round(sum(vals), 3),
            "share": round(sum(vals) / total_all, 4),
            "p50_ms": round(_percentile(vals, 0.50), 3),
            "p90_ms": round(_percentile(vals, 0.90), 3),
            "p99_ms": round(_percentile(vals, 0.99), 3),
        }
    antagonists: dict[str, dict] = {}
    for job in jobs:
        ant = job.get("antagonist") or {}
        label = antagonist_label(ant)
        slot = antagonists.setdefault(label, {"queue_ms": 0.0, "jobs": 0})
        slot["queue_ms"] = round(
            slot["queue_ms"] + float(ant.get("queue_ms") or 0.0), 3)
        slot["jobs"] += 1
    dominant = None
    if antagonists:
        dominant = max(antagonists.items(),
                       key=lambda kv: kv[1]["queue_ms"])[0]
    coverages = [j["coverage"] for j in jobs if j.get("coverage") is not None]
    return {
        "jobs": len(jobs),
        "segments": seg_table,
        "antagonists": antagonists,
        "dominant_queue_antagonist": dominant,
        "coverage_min": min(coverages) if coverages else None,
    }


def report_doc(events: list[dict]) -> dict:
    """Full ``cct critpath --json`` payload from raw events."""
    jobs = from_events(events)
    return {"jobs": jobs, "fleet": fleet_report(jobs)}


def render_report(doc: dict) -> str:
    """Human report for ``cct critpath report``; pure and unit-tested."""
    fleet = doc.get("fleet") or {}
    jobs = doc.get("jobs") or []
    lines = [f"cct critpath — {fleet.get('jobs', 0)} job(s), "
             f"min coverage "
             f"{fleet.get('coverage_min') if fleet.get('coverage_min') is not None else '-'}"]
    segs = fleet.get("segments") or {}
    if segs:
        lines.append(f"\n{'SEGMENT':<10} {'JOBS':>5} {'TOTAL':>10} "
                     f"{'SHARE':>6} {'P50':>9} {'P90':>9} {'P99':>9}")
        ordered = [s for s in SEGMENT_ORDER if s in segs] \
            + sorted(set(segs) - set(SEGMENT_ORDER))
        for name in ordered:
            row = segs[name]
            lines.append(
                f"{name:<10} {row['jobs']:>5} {row['total_ms']:>9.1f}m "
                f"{100 * row['share']:>5.1f}% {row['p50_ms']:>8.1f}m "
                f"{row['p90_ms']:>8.1f}m {row['p99_ms']:>8.1f}m")
    ants = fleet.get("antagonists") or {}
    if ants:
        lines.append("\nqueue antagonists (who made jobs wait):")
        for label, slot in sorted(ants.items(),
                                  key=lambda kv: -kv[1]["queue_ms"]):
            mark = " <- dominant" \
                if label == fleet.get("dominant_queue_antagonist") else ""
            lines.append(f"  {slot['queue_ms']:>9.1f}ms over "
                         f"{slot['jobs']} job(s): {label}{mark}")
    states: dict[str, int] = {}
    for j in jobs:
        states[str(j.get("state"))] = states.get(str(j.get("state")), 0) + 1
    if states:
        lines.append("\nterminal states: " + ", ".join(
            f"{k}={v}" for k, v in sorted(states.items())))
    return "\n".join(lines) + "\n"


def render_job(job: dict) -> str:
    """One job's chain for ``cct critpath job KEY``."""
    lines = [f"job {job.get('job_id')} key={job.get('key')} "
             f"state={job.get('state')} wall={job.get('wall_ms')}ms "
             f"coverage={job.get('coverage')}"]
    for seg in job.get("segments") or []:
        line = f"  {seg['name']:<10} {seg['ms']:>10.3f}ms"
        split = seg.get("split")
        if split:
            line += "  (" + ", ".join(
                f"{k}={v}ms" for k, v in sorted(split.items())) + ")"
        lines.append(line)
    ant = job.get("antagonist") or {}
    if ant:
        lines.append(f"  antagonist: {antagonist_label(ant)} "
                     f"(queue={ant.get('queue_ms')}ms, "
                     f"busy={ant.get('dispatcher_busy_ms')}ms, "
                     f"idle={ant.get('idle_ms')}ms)")
    return "\n".join(lines) + "\n"


def to_json(doc: dict) -> str:
    return json.dumps(doc, sort_keys=True, indent=2) + "\n"
