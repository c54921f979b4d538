"""What the per-layer readers take from the program's own record of the
window: the idle seconds each of its spans names (the ``cct.<span>`` host
annotations the program opens on the profiler's timeline, reduced by
``trace.py``), and the counters of the last command's ``run.metrics.json``
(``cli.last_run_metrics``).  Each returns None where the program has no
such span or counter, as a program without them has not."""

from __future__ import annotations

import sys


def idle_per_command(cell, span: str) -> float | None:
    """Seconds a command in which the card was idle and ``span`` was the
    innermost open span."""
    s, walls = cell.summary, getattr(cell, "walls", None)
    if s is None or not walls or span not in s.idle:
        return None
    return s.idle[span] / len(walls)


def idle_ms_per_step(cell, span: str) -> float | None:
    """Milliseconds a step in which the card was idle and ``span`` was the
    innermost open span."""
    s, steps = cell.summary, getattr(cell, "steps", 0)
    if s is None or not steps or span not in s.idle:
        return None
    return 1e3 * s.idle[span] / steps


def last_run(cell) -> dict | None:
    """The last command's ``run.metrics.json`` document, kept in memory by
    the program's CLI; None when the window ran no command or the program
    keeps none.  Every command of the window runs the same input, so the
    last stands for each."""
    if not getattr(cell, "walls", None):
        return None
    cli = sys.modules.get("consensuscruncher_tpu_torch.cli")
    last = getattr(cli, "last_run_metrics", None)
    return last() if last is not None else None
