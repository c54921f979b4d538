"""The traced run: the window under ``torch.profiler``, reduced to numbers.

Device activity is every event the profiler records on the card (kernels,
copies, sets), not the host spans it mirrors there.  The busy time is the
union of their intervals; an idle gap is a stretch of the window with
none, its seconds named by the innermost host span the benchmark had open
over them (``span``), or ``harness`` outside every span.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field


@contextlib.contextmanager
def profiled():
    """A profiler over CPU and CUDA activity; yields it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def span(name: str, on: bool = True):
    """A host span that the trace can name an idle gap by (none unless
    ``on``)."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(f"cct.{name}")


@dataclass
class Interval:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class Summary:
    """What the reduction keeps: busy and window seconds, device time by
    name ``{name: [seconds, count]}``, idle seconds by host span."""

    busy_s: float
    window_s: float
    device: dict = field(default_factory=dict)
    idle: dict = field(default_factory=dict)

    def device_seconds(self, part: str) -> tuple[float, int]:
        """Device seconds and events of every activity whose name holds
        ``part``."""
        rows = [v for k, v in self.device.items() if part in k]
        return sum(r[0] for r in rows), sum(r[1] for r in rows)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v[0]] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def union_ns(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merged, sorted intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def leaf_segments(spans: list[Interval], t0_ns: int, t1_ns: int) -> list[tuple[int, int, str]]:
    """``[t0, t1)`` cut into segments, each named by the innermost host
    span open over it (spans nest), or ``harness`` where none is."""
    events = sorted([(s.start_ns, 1, i) for i, s in enumerate(spans)]
                    + [(s.end_ns, 0, i) for i, s in enumerate(spans)])
    out, stack, at = [], [], t0_ns
    for t, is_start, i in events:
        t = min(max(t, t0_ns), t1_ns)
        if t > at:
            out.append((at, t, spans[stack[-1]].name if stack else "harness"))
            at = t
        if is_start:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    if at < t1_ns:
        out.append((at, t1_ns, spans[stack[-1]].name if stack else "harness"))
    return out


def summarize(device: list[Interval], spans: list[Interval], t0_ns: int, t1_ns: int) -> Summary:
    """Reduce device activity and host spans over the window ``[t0, t1)``."""
    by_name: dict[str, list] = {}
    clipped = []
    for ev in device:
        a, b = max(ev.start_ns, t0_ns), min(ev.end_ns, t1_ns)
        row = by_name.setdefault(ev.name, [0.0, 0])
        row[0] += (ev.end_ns - ev.start_ns) / 1e9
        row[1] += 1
        if b > a:
            clipped.append((a, b))
    busy = union_ns(clipped)
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps, at = [], t0_ns
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < t1_ns:
        gaps.append((at, t1_ns))
    idle: dict[str, float] = {}
    segs = leaf_segments(spans, t0_ns, t1_ns)
    k = 0
    for a, b in gaps:
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < b:
            lo, hi = max(a, segs[j][0]), min(b, segs[j][1])
            if hi > lo:
                idle[segs[j][2]] = idle.get(segs[j][2], 0.0) + (hi - lo) / 1e9
            j += 1
    return Summary(busy_s=busy_s, window_s=(t1_ns - t0_ns) / 1e9, device=by_name, idle=idle)


def _is_annotation(ev) -> bool:
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return "annotation" in kind()
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else ev.name().startswith("cct.")


def from_profiler(prof, t0_ns: int | None = None, t1_ns: int | None = None) -> Summary:
    """:func:`summarize` over a finished profiler's events; the window is
    the benchmark's ``cct.window`` span unless given."""
    from torch.autograd import DeviceType

    device, spans = [], []
    window = None
    events = prof.profiler.kineto_results.events()
    # the host spans the profiler mirrors onto the card's timeline carry the
    # names of the host's user annotations
    mirrored = {ev.name() for ev in events
                if ev.device_type() != DeviceType.CUDA and _is_annotation(ev)}
    for ev in events:
        iv = Interval(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if ev.device_type() == DeviceType.CUDA:
            if iv.name not in mirrored and not _is_annotation(ev):
                device.append(iv)
        elif iv.name.startswith("cct."):
            if iv.name == "cct.window":
                window = iv
            else:
                spans.append(Interval(iv.name[4:], iv.start_ns, iv.end_ns))
    if t0_ns is None:
        if window is None:
            raise RuntimeError("the trace holds no cct.window span")
        t0_ns, t1_ns = window.start_ns, window.end_ns
    return summarize(device, spans, t0_ns, t1_ns)
