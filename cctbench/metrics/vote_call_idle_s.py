"""`ops.consensus_segment` vote call (the `vote.call` span: a batch's upload, vote
and download, less its nested `vote.checks`, `vote.plan` and `vote.launch`):
seconds a command the card was idle with it innermost."""

from cctbench import spans


def read(cell):
    return spans.idle_per_command(cell, "vote.call")
