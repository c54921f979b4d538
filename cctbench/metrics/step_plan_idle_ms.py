"""`ops.consensus_vote` tile plan (the `vote.plan` span: the outputs, the grid,
`tiles.plan_tiles` with its pinned buffer): milliseconds a step the card was
idle with it innermost."""

from cctbench import spans


def read(cell):
    return spans.idle_ms_per_step(cell, "vote.plan")
