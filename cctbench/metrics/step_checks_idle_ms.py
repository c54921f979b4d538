"""`ops.consensus_vote` checks (the `vote.checks` span: the wire's and the
families' checks, the strands' views): milliseconds a step the card was idle
with it innermost."""

from cctbench import spans


def read(cell):
    return spans.idle_ms_per_step(cell, "vote.checks")
