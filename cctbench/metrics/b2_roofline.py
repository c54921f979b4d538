"""Kernel B2 (`vote_tiles_kernel<raw, true, false>`): the least time of a step's
work (`cctbench/work.py`, counted from the inputs) over the profiler's device
time per launch of the vote kernel, in percent."""

from cctbench import work

KERNEL = "vote_tiles_kernel"


def read(cell):
    if cell.summary is None:
        return None
    seconds, launches = cell.summary.device_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    card = work.peaks(cell.card_kind)
    steps = cell.step_work()
    least = sum(work.least_seconds(w, card)[0] for w in steps) / len(steps)
    return 100.0 * least / (seconds / launches)
