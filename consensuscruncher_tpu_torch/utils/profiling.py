"""Tracing/profiling of a run and the per-stage metrics sidecars.

Port of ``consensuscruncher_tpu/utils/profiling.py``:

- :func:`maybe_profile` — wrap a region in ``torch.profiler.profile``
  (host ops, and the card's kernels and copies when the run is on CUDA)
  and export a Chrome trace (open in Perfetto or ``chrome://tracing``)
  when a trace directory is given; a no-op when not.  Where the JAX
  package writes a ``jax.profiler`` trace, the port writes
  ``<dir>/consensus.<pid>.trace.json``; :func:`trace_summary` reads the
  device's busy share of the traced window from it.
- :func:`write_metrics` — structured per-stage metrics JSON (phase
  wall-clock, derived throughput such as families/sec, and the
  ``cumulative`` counter block), next to the human-readable tracker file.
  Run-specific by nature, so no golden digest and no manifest covers it,
  exactly like the tracker.
"""

from __future__ import annotations

import json
import os
import threading
from contextlib import contextmanager

from consensuscruncher_tpu_torch.io import bgzf
from consensuscruncher_tpu_torch.obs import metrics as obs_metrics
from consensuscruncher_tpu_torch.obs.registry import CUMULATIVE_KEYS

# Chrome-trace categories of work on the card (kernels, copies, fills)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the span maybe_profile records around its whole body
RUN_SPAN = "cct.run"


class Counters:
    """Thread-safe cumulative counters over :data:`CUMULATIVE_KEYS`.

    ``add`` accumulates, ``high_water`` keeps a running max (for gauges like
    queue depth), ``snapshot`` returns a plain dict with every key present.
    Keys outside the registry raise ``KeyError`` — an unregistered counter
    would silently vanish from ``snapshot``'s normalised schema.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values = {k: 0 for k in CUMULATIVE_KEYS}

    @staticmethod
    def _check(key: str) -> None:
        if key not in CUMULATIVE_KEYS:
            raise KeyError(
                f"unknown counter {key!r}; register it in "
                f"consensuscruncher_tpu_torch/obs/registry.py CUMULATIVE_KEYS")

    def add(self, key: str, amount: int = 1) -> None:
        self._check(key)
        with self._lock:
            self._values[key] += int(amount)

    def high_water(self, key: str, value: int) -> None:
        self._check(key)
        with self._lock:
            if int(value) > self._values[key]:
                self._values[key] = int(value)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            out = {k: 0 for k in CUMULATIVE_KEYS}
            out.update(self._values)
            return out


def counter_marks() -> dict[str, int]:
    """The process-wide counters whose change over a stage its
    ``cumulative`` block reports: kernel builds, bytes to and from the
    card, and the BGZF deflate wall and bytes written."""
    io = bgzf.write_stats()
    moved = obs_metrics.transfer_bytes()
    return {"recompiles": obs_metrics.recompiles(), "bytes_h2d": moved["h2d"],
            "bytes_d2h": moved["d2h"], "deflate_wall_us": io["deflate_wall_us"],
            "bytes_bam_written": io["bytes_written"]}


def add_counter_deltas(cum: Counters, marks: dict[str, int]) -> None:
    """Add the change of :func:`counter_marks` since ``marks`` to ``cum``."""
    for key, value in counter_marks().items():
        cum.add(key, value - marks[key])


def trace_path(trace_dir: str) -> str:
    """Where :func:`maybe_profile` exports this process's Chrome trace."""
    return os.path.join(trace_dir, f"consensus.{os.getpid()}.trace.json")


@contextmanager
def maybe_profile(trace_dir: str | None, cuda: bool = False):
    """``torch.profiler.profile`` around the body when ``trace_dir`` is
    set, else a no-op.  ``cuda``: trace the card's activity too (only a
    process that drives the card asks for it: the CUDA tracer would open
    a context on the card).  Shapes, stacks and memory are not recorded,
    which keeps the trace small and the overhead low.  The Chrome trace
    lands at :func:`trace_path` when the body ends, also when it raises."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities, record_shapes=False, with_stack=False,
                   profile_memory=False)
    prof.start()
    try:
        # one span over the whole body: the traced window runs from its
        # start to its end, not from the first torch op to the last
        with record_function(RUN_SPAN):
            yield
    finally:
        prof.stop()
        prof.export_chrome_trace(trace_path(trace_dir))


def trace_summary(path: str) -> dict:
    """The device's share of a Chrome trace's window: the union of the
    card's kernel, copy and fill intervals over the span from the trace's
    first event to its last (host events included; in a trace of
    :func:`maybe_profile` the :data:`RUN_SPAN` span covers its whole
    body), and the kernels by name (launch count and summed
    microseconds)."""
    with open(path) as fh:
        events = json.load(fh)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    spans, device, kernels = [], [], {}
    for ev in events:
        if ev.get("ph") != "X" or "ts" not in ev:
            continue
        t0, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans.append((t0, t0 + dur))
        if ev.get("cat") in _DEVICE_CATS:
            device.append((t0, t0 + dur))
            if ev.get("cat") == "kernel":
                k = kernels.setdefault(ev.get("name", "?"), {"count": 0, "us": 0.0})
                k["count"] += 1
                k["us"] += dur
    window = (max(e for _s, e in spans) - min(s for s, _e in spans)) if spans else 0.0
    busy, end = 0.0, float("-inf")
    for s, e in sorted(device):
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"window_us": window, "device_busy_us": busy,
            "device_busy_share": busy / window if window else 0.0,
            "device_events": len(device), "kernels": kernels}


def metrics_doc(stage: str, phases: dict[str, float],
                counters: dict[str, object],
                cumulative: dict[str, int] | None = None) -> dict[str, object]:
    """The metrics document of the stage sidecars: ``{stage, phases_s,
    total_s, **counters}`` plus derived ``<unit>_per_sec`` rates for any
    counter named ``n_<unit>``, and a ``cumulative`` block normalised over
    :data:`CUMULATIVE_KEYS`."""
    total = sum(phases.values())
    doc: dict[str, object] = {"stage": stage, "phases_s": {
        k: round(v, 6) for k, v in phases.items()
    }, "total_s": round(total, 6)}
    doc.update(counters)
    if total > 0:
        for key, value in counters.items():
            if key.startswith("n_") and isinstance(value, (int, float)):
                doc[f"{key[2:]}_per_sec"] = round(value / total, 2)
    if cumulative is not None:
        block = {k: 0 for k in CUMULATIVE_KEYS}
        block.update({k: int(v) for k, v in cumulative.items()})
        doc["cumulative"] = block
    return doc


def write_metrics(path, stage: str, phases: dict[str, float],
                  counters: dict[str, object],
                  cumulative: dict[str, int] | None = None) -> None:
    """Write :func:`metrics_doc` as an indented-JSON sidecar."""
    doc = metrics_doc(stage, phases, counters, cumulative=cumulative)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
