"""`ops.consensus_segment` wire encode (the `vote.encode` span): seconds a
command the card was idle with it innermost."""

from cctbench import spans


def read(cell):
    return spans.idle_per_command(cell, "vote.encode")
