"""Kernel B1 (`vote_tiles_kernel<wire, false, qc>`, the SSCS vote): the least
time of a command's vote work over the profiler's device time of the window's
B1 launches a command, in percent.  The work is the last command's
`vote_member_positions` and `vote_output_positions` (its `run.metrics.json`):
a byte of base and one of quality a live member-position, both output planes
once, `work.FOLD_OPS` a member-position and `work.FINALIZE_OPS` an output
position."""

from cctbench import spans, work

KERNEL = "vote_tiles_kernel<"


def is_b1(name: str) -> bool:
    """A launch of the vote kernel whose duplex template argument is false."""
    at = name.find(KERNEL)
    if at < 0:
        return False
    args = name[at + len(KERNEL):].split(">", 1)[0].split(",")
    return len(args) > 1 and args[1].strip() == "false"


def read(cell):
    run = spans.last_run(cell)
    if cell.summary is None or run is None or "vote_member_positions" not in run:
        return None
    rows = [v for k, v in cell.summary.device.items() if is_b1(k)]
    seconds, launches = sum(r[0] for r in rows), sum(r[1] for r in rows)
    if not launches or seconds <= 0:
        return None
    m, o = run["vote_member_positions"], run["vote_output_positions"]
    w = {"bytes": 2 * m + 2 * o, "ops": work.FOLD_OPS * m + work.FINALIZE_OPS * o}
    least = work.least_seconds(w, work.peaks(cell.card_kind))[0]
    return 100.0 * least / (seconds / len(cell.walls))
