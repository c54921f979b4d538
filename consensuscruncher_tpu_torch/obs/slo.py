"""Per-class SLO monitor: latency quantiles, shed rate, burn rates.

The serve scheduler feeds one :class:`SloMonitor` with every terminal
job event (``note(qos, wall_s, shed=...)``).  The monitor keeps, per
qos class:

- a fixed-bucket latency histogram (the registry's shared latency
  buckets, so p50/p99 here line up with the labeled exposition);
- cumulative totals (events, sheds, SLO violations);
- a bounded ring of timestamped cumulative samples from which
  multi-window error-budget **burn rates** are computed, SRE-style:
  ``burn = (violations/total over the window) / (1 - objective)`` —
  1.0 means the class is consuming budget exactly at the rate that
  exhausts it by the end of the compliance period, >1 is an alert.

A job *violates* its SLO when it was shed, or when it finished slower
than the class target.  Classes without a configured target only count
sheds, so the monitor is inert (all-zero burn) on the default
single-tenant path.

Stdlib-only, jax-free, like the rest of obs/.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from consensuscruncher_tpu_torch.obs.metrics import Histogram
from consensuscruncher_tpu_torch.obs.registry import LABELED_HISTOGRAMS, QOS_CLASSES

_BUCKETS = LABELED_HISTOGRAMS["tenant_job_wall_s"]["buckets"]

# Default multi-window burn horizons (seconds): a fast window that
# catches sudden budget fires and a slow one that catches smolder.
DEFAULT_WINDOWS = (300.0, 3600.0)


def quantile_from_histogram(buckets, counts, q):
    """Estimate the ``q`` quantile (0..1) from fixed-bucket counts with
    linear interpolation inside the containing bucket.  ``counts`` has
    one extra +Inf slot; values there clamp to the last finite bound.
    Returns None when the histogram is empty."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    acc = 0.0
    for i, n in enumerate(counts):
        if n == 0:
            continue
        if acc + n >= target:
            if i >= len(buckets):  # +Inf bucket: no finite upper bound
                return float(buckets[-1])
            lo = float(buckets[i - 1]) if i > 0 else 0.0
            hi = float(buckets[i])
            frac = (target - acc) / n
            return lo + frac * (hi - lo)
        acc += n
    return float(buckets[-1])


class _ClassState:
    __slots__ = ("hist", "total", "shed", "violations", "samples")

    def __init__(self):
        self.hist = Histogram(_BUCKETS)
        self.total = 0
        self.shed = 0
        self.violations = 0
        self.samples = deque()  # (t, total, violations)


class SloMonitor:
    """Aggregates terminal job events into per-class SLO health."""

    def __init__(self, targets=None, objective=0.99, windows=DEFAULT_WINDOWS,
                 clock=time.monotonic):
        self.targets = {qos: None for qos in QOS_CLASSES}
        for qos, t in (targets or {}).items():
            if qos not in self.targets:
                raise KeyError(f"unknown qos class {qos!r} in SLO targets")
            self.targets[qos] = None if t is None else float(t)
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        self.objective = float(objective)
        self.windows = tuple(float(w) for w in windows)
        self._clock = clock
        self._lock = threading.Lock()
        self._classes = {qos: _ClassState() for qos in QOS_CLASSES}

    def note(self, qos: str, wall_s=None, shed: bool = False) -> None:
        """Record one terminal job: ``wall_s`` is submit-to-terminal wall
        (None for sheds that never ran); ``shed`` marks refusals."""
        st = self._classes[qos]
        target = self.targets[qos]
        violated = bool(shed) or (
            target is not None and wall_s is not None and wall_s > target
        )
        now = self._clock()
        with self._lock:
            st.total += 1
            if shed:
                st.shed += 1
            if violated:
                st.violations += 1
            if wall_s is not None:
                st.hist.observe(wall_s)
            st.samples.append((now, st.total, st.violations))
            horizon = now - max(self.windows) - 1.0
            while st.samples and st.samples[0][0] < horizon:
                st.samples.popleft()

    def _burn(self, st: _ClassState, window: float, now: float):
        """Burn rate over ``window``: violation fraction of the events
        inside it, normalized by the error budget (1 - objective)."""
        if not st.samples:
            return 0.0
        cutoff = now - window
        base_total = base_viol = 0
        for t, total, viol in st.samples:
            if t >= cutoff:
                break
            base_total, base_viol = total, viol
        d_total = st.total - base_total
        d_viol = st.violations - base_viol
        if d_total <= 0:
            return 0.0
        return (d_viol / d_total) / (1.0 - self.objective)

    def snapshot(self) -> dict:
        """Stable-schema doc: every qos class is present whether or not
        it has traffic, so the exposition never flaps."""
        now = self._clock()
        classes = {}
        with self._lock:
            for qos in QOS_CLASSES:
                st = self._classes[qos]
                h = st.hist.snapshot()
                classes[qos] = {
                    "target_s": self.targets[qos],
                    "total": st.total,
                    "shed": st.shed,
                    "violations": st.violations,
                    "shed_ratio": (st.shed / st.total) if st.total else 0.0,
                    "p50_s": quantile_from_histogram(
                        h["buckets"], h["counts"], 0.50),
                    "p99_s": quantile_from_histogram(
                        h["buckets"], h["counts"], 0.99),
                    "burn_rate": {
                        f"{int(w)}s": round(self._burn(st, w, now), 6)
                        for w in self.windows
                    },
                }
        return {"objective": self.objective, "classes": classes}

    def health(self) -> dict:
        """Compact healthz block: the worst burn rate across classes and
        windows plus which class owns it."""
        snap = self.snapshot()
        worst = 0.0
        worst_qos = None
        for qos, c in snap["classes"].items():
            for v in c["burn_rate"].values():
                if v > worst:
                    worst, worst_qos = v, qos
        return {
            "objective": snap["objective"],
            "worst_burn_rate": round(worst, 6),
            "worst_burn_class": worst_qos,
        }
