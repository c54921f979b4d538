"""Fixed-bucket histograms, the build counter, transfer bytes, and the
Prometheus rendering of a metrics document.

Port of ``consensuscruncher_tpu/obs/metrics.py``.  Histograms are always
on: they are part of the serve ``metrics`` endpoint contract, and a lock
and a bisect per device batch or journal append is noise next to the
fsync or dispatch they measure.  Names must exist in :mod:`.registry`;
observing an unknown name raises, as ``utils.profiling.Counters`` does
for counters.

- Transfer bytes are counted at the port's own upload and download sites
  on the consensus path (the stream and dense votes, the duplex votes,
  the residency gathers, the Hamming matcher, the QC total), and only
  when the copy crosses to or from a CUDA device: a ``--device cpu`` run
  counts 0.
- The port has no JIT, so nothing recompiles per shape as XLA does.
  ``recompiles`` counts the kernel libraries that ``ops.cuda_lib.build``
  compiled with ``nvcc`` in this process (0 once the build directory
  holds them); :func:`note_compile` records one build signature.

This module must not import ``utils.profiling`` (profiling imports the
registry too; keeping metrics independent kills the cycle risk).
"""

from __future__ import annotations

import os
import sys
import threading
from bisect import bisect_left

from consensuscruncher_tpu_torch.obs.registry import (
    COUNTERS,
    GAUGES,
    HISTOGRAMS,
    LABELED_COUNTERS,
    LABELED_HISTOGRAMS,
    LABELS,
    OVERFLOW_TENANT,
)


class Histogram:
    """Thread-safe fixed-bucket histogram (Prometheus ``le`` semantics:
    a value lands in the first bucket whose upper bound is >= it)."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, buckets):
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value) -> None:
        v = float(value)
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "buckets": list(self.buckets),
                "counts": list(self._counts),
                "sum": round(self._sum, 6),
                "count": self._count,
            }


def _zero_snapshot(name: str) -> dict:
    buckets = list(HISTOGRAMS[name]["buckets"])
    return {"buckets": buckets, "counts": [0] * (len(buckets) + 1),
            "sum": 0.0, "count": 0}


_lock = threading.Lock()
_hists: dict[str, Histogram] = {}
_recompiles = 0
_seen_signatures: set = set()


def get_histogram(name: str) -> Histogram:
    try:
        spec = HISTOGRAMS[name]
    except KeyError:
        raise KeyError(
            f"unknown histogram {name!r}; register it in "
            f"consensuscruncher_tpu_torch/obs/registry.py HISTOGRAMS"
        ) from None
    h = _hists.get(name)
    if h is None:
        with _lock:
            h = _hists.setdefault(name, Histogram(spec["buckets"]))
    return h


def observe(name: str, value) -> None:
    get_histogram(name).observe(value)


def histogram_sum(name: str) -> float:
    """Cumulative observed sum of one registered histogram (0.0 when it
    was never observed).  The profiler's span-delta attribution reads
    ``device_dispatch_s`` through this between job-span enter/exit."""
    h = _hists.get(name)
    if h is None:
        return 0.0
    with h._lock:
        return h._sum


def histograms_snapshot() -> dict:
    """All registered histograms, zero-filled when never observed, so
    every metrics doc / bench sidecar carries an identical schema."""
    out = {}
    for name in HISTOGRAMS:
        h = _hists.get(name)
        out[name] = h.snapshot() if h is not None else _zero_snapshot(name)
    return out


# ------------------------------------------------------- labeled series
#
# Per-(tenant, qos) counters and histograms.  Label names per metric and
# the qos value set are closed in the registry; tenant is open-valued
# but capped at CCT_OBS_MAX_TENANTS live values per process — the first
# observation past the cap folds into OVERFLOW_TENANT, so exposition
# size is bounded no matter what tenant ids clients invent.

_labeled_counts: dict[tuple, int] = {}
_labeled_hists: dict[tuple, Histogram] = {}
_seen_tenants: set = set()


def _max_tenants() -> int:
    try:
        return int(os.environ.get("CCT_OBS_MAX_TENANTS", "64"))
    except ValueError:
        return 64


def _check_labels(name: str, spec: dict, labels: dict) -> tuple:
    """Validate a label dict against the registry spec and return the
    canonical hashable series key ``(name, (v1, v2, ...))`` in the
    spec's label order, with tenant cardinality capping applied."""
    want = spec["labels"]
    if set(labels) != set(want):
        raise KeyError(
            f"metric {name!r} takes labels {want}, got {tuple(sorted(labels))}"
        )
    values = []
    for key in want:
        val = str(labels[key])
        reg = LABELS[key]
        if reg["closed"] and val not in reg["values"]:
            raise ValueError(
                f"label {key}={val!r} not in closed set {reg['values']}"
            )
        if key == "tenant" and val not in _seen_tenants:
            if len(_seen_tenants) >= _max_tenants():
                val = OVERFLOW_TENANT
            else:
                _seen_tenants.add(val)
        values.append(val)
    return (name, tuple(values))


def inc(name: str, value: int = 1, **labels) -> None:
    """Increment a labeled counter, e.g.
    ``inc("tenant_jobs_done", tenant="acme", qos="batch")``."""
    try:
        spec = LABELED_COUNTERS[name]
    except KeyError:
        raise KeyError(
            f"unknown labeled counter {name!r}; register it in "
            f"consensuscruncher_tpu_torch/obs/registry.py LABELED_COUNTERS"
        ) from None
    with _lock:
        key = _check_labels(name, spec, labels)
        _labeled_counts[key] = _labeled_counts.get(key, 0) + int(value)


def observe_labeled(name: str, value, **labels) -> None:
    """Observe into a labeled histogram, e.g.
    ``observe_labeled("tenant_job_wall_s", 0.2, tenant="a", qos="batch")``."""
    try:
        spec = LABELED_HISTOGRAMS[name]
    except KeyError:
        raise KeyError(
            f"unknown labeled histogram {name!r}; register it in "
            f"consensuscruncher_tpu_torch/obs/registry.py LABELED_HISTOGRAMS"
        ) from None
    with _lock:
        key = _check_labels(name, spec, labels)
        h = _labeled_hists.get(key)
        if h is None:
            h = _labeled_hists.setdefault(key, Histogram(spec["buckets"]))
    h.observe(value)


def labeled_snapshot() -> dict:
    """All live labeled series, as
    ``{"counters": {name: [{"labels": {...}, "value": n}, ...]},
       "histograms": {name: [{"labels": {...}, ...snapshot}, ...]}}``
    with entries sorted by label values for a stable wire schema."""
    with _lock:
        counts = dict(_labeled_counts)
        hists = dict(_labeled_hists)
    out: dict = {"counters": {}, "histograms": {}}
    for (name, values), n in sorted(counts.items()):
        labels = dict(zip(LABELED_COUNTERS[name]["labels"], values))
        out["counters"].setdefault(name, []).append(
            {"labels": labels, "value": n})
    for (name, values), h in sorted(hists.items()):
        labels = dict(zip(LABELED_HISTOGRAMS[name]["labels"], values))
        snap = h.snapshot()
        snap["labels"] = labels
        out["histograms"].setdefault(name, []).append(snap)
    return out


# ------------------------------------------------------ transfer bytes
#
# Process-wide measured host<->card byte counters, fed by every ops/
# dispatch site; stages export per-stage deltas into their cumulative
# sidecars the same way they export build deltas.

_transfer_bytes = {"h2d": 0, "d2h": 0}


def note_transfer(direction: str, nbytes: int, device=None) -> None:
    """Record ``nbytes`` moved host->device (``"h2d"``) or device->host
    (``"d2h"``).  ``device``: the device side of the copy; a copy that
    stays on the CPU counts nothing (the port's CPU runs move no bytes
    over a bus)."""
    if direction not in _transfer_bytes:
        raise KeyError(f"transfer direction must be 'h2d' or 'd2h', got {direction!r}")
    if device is not None and getattr(device, "type", device) != "cuda":
        return
    with _lock:
        _transfer_bytes[direction] += int(nbytes)


def transfer_bytes() -> dict:
    """Snapshot ``{"h2d": total_bytes, "d2h": total_bytes}``."""
    with _lock:
        return dict(_transfer_bytes)


def note_compile(signature) -> bool:
    """Record one kernel-library build signature (the library's content-
    keyed path); True on first sighting in this process, which is what
    ``recompiles`` counts."""
    global _recompiles
    with _lock:
        if signature in _seen_signatures:
            return False
        _seen_signatures.add(signature)
        _recompiles += 1
    if os.environ.get("CCT_OBS_LOG_COMPILES"):
        print(f"obs: kernel library built {signature!r}", file=sys.stderr, flush=True)
    return True


def note_build(path: str) -> None:
    """Record the kernel library at ``path`` compiled by ``nvcc`` in this
    process."""
    note_compile(path)


def recompiles() -> int:
    """Kernel libraries built in this process (the port's counterpart of
    the JAX package's first-sighting dispatch signatures)."""
    with _lock:
        return _recompiles


def reset_for_tests() -> None:
    global _recompiles
    with _lock:
        _hists.clear()
        _seen_signatures.clear()
        _recompiles = 0
        _labeled_counts.clear()
        _labeled_hists.clear()
        _seen_tenants.clear()
        _transfer_bytes["h2d"] = 0
        _transfer_bytes["d2h"] = 0


# ------------------------------------------------------- Prometheus text

def _fmt(v) -> str:
    if isinstance(v, float):
        return repr(round(v, 9))
    return str(int(v))


def _escape_label_value(v) -> str:
    # Text exposition 0.0.4: backslash, double-quote and newline must be
    # escaped inside label values; everything else passes through.
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _canary_lines(canary: dict, labels: dict | None = None) -> list[str]:
    """The ``cct_canary_ok`` / ``cct_canary_age_s`` gauge lines from a
    metrics doc's ``canary`` status (absent when no prober runs);
    ``labels`` adds a node label for the fleet exposition."""
    if not isinstance(canary, dict) or "ok" not in canary:
        return []
    suffix = _label_str(labels) if labels else ""
    lines = []
    if not labels:
        lines.append(f"# HELP cct_canary_ok {GAUGES['canary_ok']}")
    lines.append("# TYPE cct_canary_ok gauge")
    lines.append(f"cct_canary_ok{suffix} {1 if canary['ok'] else 0}")
    age = canary.get("age_s")
    if age is not None:
        if not labels:
            lines.append(f"# HELP cct_canary_age_s {GAUGES['canary_age_s']}")
        lines.append("# TYPE cct_canary_age_s gauge")
        lines.append(f"cct_canary_age_s{suffix} {_fmt(float(age))}")
    return lines


def _label_str(labels: dict) -> str:
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_prometheus(doc: dict) -> str:
    """Render a serve ``metrics`` doc (the JSON the endpoint already
    serves) as Prometheus text exposition format 0.0.4."""
    lines: list[str] = []

    cum = doc.get("cumulative") or {}
    for name in sorted(cum):
        metric = f"cct_{name}_total"
        lines.append(f"# HELP {metric} {COUNTERS.get(name, name)}")
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {_fmt(cum[name])}")

    states = doc.get("jobs_by_state") or {}
    if states:
        lines.append("# TYPE cct_jobs gauge")
        for state in sorted(states):
            lines.append(f'cct_jobs{{state="{state}"}} {_fmt(states[state])}')

    for gauge in ("n_jobs", "queue_bound", "gang_size"):
        if gauge in doc:
            lines.append(f"# TYPE cct_{gauge} gauge")
            lines.append(f"cct_{gauge} {_fmt(doc[gauge])}")
    if "draining" in doc:
        lines.append("# TYPE cct_draining gauge")
        lines.append(f"cct_draining {1 if doc['draining'] else 0}")

    phases = doc.get("phases_s") or {}
    if "uptime" in phases:
        lines.append("# TYPE cct_uptime_seconds gauge")
        lines.append(f"cct_uptime_seconds {_fmt(float(phases['uptime']))}")

    journal = doc.get("journal") or {}
    if "size_bytes" in journal:
        lines.append("# TYPE cct_journal_size_bytes gauge")
        lines.append(f"cct_journal_size_bytes {_fmt(journal['size_bytes'])}")

    lines.extend(_canary_lines(doc.get("canary") or {}))

    for name in sorted(doc.get("histograms") or {}):
        h = doc["histograms"][name]
        metric = f"cct_{name}"
        spec = HISTOGRAMS.get(name, {})
        if spec.get("help"):
            lines.append(f"# HELP {metric} {spec['help']}")
        lines.append(f"# TYPE {metric} histogram")
        acc = 0
        for bound, n in zip(h["buckets"], h["counts"]):
            acc += n
            lines.append(f'{metric}_bucket{{le="{bound:g}"}} {acc}')
        lines.append(f'{metric}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{metric}_sum {_fmt(float(h['sum']))}")
        lines.append(f"{metric}_count {h['count']}")

    labeled = doc.get("labeled") or {}
    for name in sorted(labeled.get("counters") or {}):
        metric = f"cct_{name}_total"
        spec = LABELED_COUNTERS.get(name, {})
        if spec.get("help"):
            lines.append(f"# HELP {metric} {spec['help']}")
        lines.append(f"# TYPE {metric} counter")
        for entry in labeled["counters"][name]:
            lines.append(
                f"{metric}{_label_str(entry['labels'])} {_fmt(entry['value'])}"
            )
    for name in sorted(labeled.get("histograms") or {}):
        metric = f"cct_{name}"
        spec = LABELED_HISTOGRAMS.get(name, {})
        if spec.get("help"):
            lines.append(f"# HELP {metric} {spec['help']}")
        lines.append(f"# TYPE {metric} histogram")
        for h in labeled["histograms"][name]:
            labels = dict(h["labels"])
            acc = 0
            for bound, n in zip(h["buckets"], h["counts"]):
                acc += n
                lines.append(
                    f"{metric}_bucket"
                    f"{_label_str({**labels, 'le': f'{bound:g}'})} {acc}"
                )
            lines.append(
                f"{metric}_bucket{_label_str({**labels, 'le': '+Inf'})} "
                f"{h['count']}"
            )
            lines.append(f"{metric}_sum{_label_str(labels)} {_fmt(float(h['sum']))}")
            lines.append(f"{metric}_count{_label_str(labels)} {h['count']}")

    classes = (doc.get("slo") or {}).get("classes") or {}
    if classes:
        for metric, key, help_ in (
            ("cct_slo_target_seconds", "target_s",
             "configured per-class SLO latency target"),
            ("cct_slo_p50_seconds", "p50_s",
             "per-class p50 job latency (histogram estimate)"),
            ("cct_slo_p99_seconds", "p99_s",
             "per-class p99 job latency (histogram estimate)"),
            ("cct_slo_shed_ratio", "shed_ratio",
             "shed jobs over total submitted per class"),
        ):
            rows = [
                (qos, classes[qos].get(key))
                for qos in sorted(classes)
                if classes[qos].get(key) is not None
            ]
            if not rows:
                continue
            lines.append(f"# HELP {metric} {help_}")
            lines.append(f"# TYPE {metric} gauge")
            for qos, v in rows:
                lines.append(
                    f"{metric}{_label_str({'qos': qos})} {_fmt(float(v))}"
                )
        burn_rows = []
        for qos in sorted(classes):
            for window, v in sorted(
                (classes[qos].get("burn_rate") or {}).items()
            ):
                if v is not None:
                    burn_rows.append((qos, window, v))
        if burn_rows:
            lines.append(
                "# HELP cct_slo_burn_rate "
                "multi-window SLO error-budget burn rate per class"
            )
            lines.append("# TYPE cct_slo_burn_rate gauge")
            for qos, window, v in burn_rows:
                lines.append(
                    "cct_slo_burn_rate"
                    f"{_label_str({'qos': qos, 'window': window})} "
                    f"{_fmt(float(v))}"
                )

    return "\n".join(lines) + "\n"


def render_fleet_prometheus(doc: dict) -> str:
    """Render the fleet router's ``metrics`` doc as one exposition: the
    router's own counters and the cross-node merged labeled series (via
    :func:`render_prometheus`), ``cct_fleet_*`` gauges describing the
    membership, and every member's counters/histograms re-emitted with a
    ``node`` label — one scrape endpoint for the whole fleet."""
    head = render_prometheus({
        k: doc.get(k)
        for k in ("cumulative", "labeled", "draining", "phases_s")
    })
    lines = [head.rstrip("\n")] if head.strip() else []

    if doc.get("epoch") is not None:
        lines.append("# HELP cct_router_epoch ring-view epoch this router "
                     "is serving at (bumps on every takeover)")
        lines.append("# TYPE cct_router_epoch gauge")
        lines.append(f"cct_router_epoch {_fmt(int(doc.get('epoch') or 0))}")
        lines.append("# HELP cct_router_active 1 while this router is the "
                     "active (non-standby, non-fenced) front door")
        lines.append("# TYPE cct_router_active gauge")
        lines.append("cct_router_active "
                     f"{1 if doc.get('ha_state') == 'active' else 0}")

    fleet = doc.get("fleet") or {}
    members = fleet.get("members") or []
    lines.append("# HELP cct_fleet_members configured fleet member count")
    lines.append("# TYPE cct_fleet_members gauge")
    lines.append(f"cct_fleet_members {_fmt(fleet.get('size', len(members)))}")
    lines.append("# HELP cct_fleet_members_up members answering health "
                 "probes")
    lines.append("# TYPE cct_fleet_members_up gauge")
    lines.append(f"cct_fleet_members_up {_fmt(fleet.get('up', 0))}")
    for metric, key, help_ in (
        ("cct_fleet_member_up", "up", "1 while the member is routable"),
        ("cct_fleet_queue_depth", "queued",
         "queued jobs on the member (router's last health probe)"),
        ("cct_fleet_running", "running", "running jobs on the member"),
        ("cct_fleet_quarantined", "quarantined",
         "quarantined poison keys parked on the member (healthz-"
         "reported; absent for pre-quarantine daemons)"),
        ("cct_fleet_draining", "draining", "1 while the member drains"),
    ):
        if not members:
            break
        lines.append(f"# HELP {metric} {help_}")
        lines.append(f"# TYPE {metric} gauge")
        for m in sorted(members, key=lambda m: m["name"]):
            v = m.get(key)
            v = (1 if v else 0) if isinstance(v, bool) else int(v or 0)
            lines.append(
                f"{metric}{_label_str({'node': m['name']})} {_fmt(v)}")

    # per-member re-emission: the same series every daemon already
    # exposes, node-labeled so one scrape shows the whole fleet
    nodes = doc.get("nodes") or {}
    for node in sorted(nodes):
        ndoc = nodes[node]
        if not ndoc:
            continue  # down/unreachable member: gauges above cover it
        cum = ndoc.get("cumulative") or {}
        for name in sorted(cum):
            metric = f"cct_{name}_total"
            lines.append(f"# TYPE {metric} counter")
            lines.append(
                f"{metric}{_label_str({'node': node})} {_fmt(cum[name])}")
        for name in sorted(ndoc.get("histograms") or {}):
            h = ndoc["histograms"][name]
            metric = f"cct_{name}"
            lines.append(f"# TYPE {metric} histogram")
            acc = 0
            for bound, n in zip(h["buckets"], h["counts"]):
                acc += n
                lines.append(
                    f"{metric}_bucket"
                    f"{_label_str({'node': node, 'le': f'{bound:g}'})} {acc}")
            lines.append(
                f"{metric}_bucket{_label_str({'node': node, 'le': '+Inf'})} "
                f"{h['count']}")
            lines.append(
                f"{metric}_sum{_label_str({'node': node})} "
                f"{_fmt(float(h['sum']))}")
            lines.append(
                f"{metric}_count{_label_str({'node': node})} {h['count']}")
        # node-labeled canary gauges: one scrape answers "is every
        # member still producing byte-correct answers"
        lines.extend(_canary_lines(ndoc.get("canary") or {},
                                   labels={"node": node}))
        # node-labeled SLO gauges: per-class latency percentiles and
        # error-budget burn rates fleet-wide in one scrape (``cct top``
        # reads these for its per-qos panel)
        classes = (ndoc.get("slo") or {}).get("classes") or {}
        for qos in sorted(classes):
            c = classes[qos]
            for metric, key in (("cct_slo_target_seconds", "target_s"),
                                ("cct_slo_p50_seconds", "p50_s"),
                                ("cct_slo_p99_seconds", "p99_s"),
                                ("cct_slo_shed_ratio", "shed_ratio")):
                if c.get(key) is not None:
                    lines.append(f"# TYPE {metric} gauge")
                    lines.append(
                        f"{metric}{_label_str({'node': node, 'qos': qos})} "
                        f"{_fmt(float(c[key]))}")
            for window, v in sorted((c.get("burn_rate") or {}).items()):
                if v is not None:
                    lines.append("# TYPE cct_slo_burn_rate gauge")
                    lines.append(
                        "cct_slo_burn_rate"
                        f"{_label_str({'node': node, 'qos': qos, 'window': window})} "
                        f"{_fmt(float(v))}")

    return "\n".join(lines) + "\n"
