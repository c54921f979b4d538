"""`parallel.mesh` step, host side (checks, tile plan, launch): milliseconds of
host clock a step call, with no synchronise, over the window."""


def read(cell):
    return 1e3 * cell.host_s / cell.steps if cell.steps else None
