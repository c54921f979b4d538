"""`ops.consensus_vote` launch (the `vote.launch` span: the family records and
their pinned copy, the arguments, the launch): milliseconds a step the card
was idle with it innermost."""

from cctbench import spans


def read(cell):
    return spans.idle_ms_per_step(cell, "vote.launch")
