"""`stages.sscs_maker` emission (the `sscs.emit` span: a vote batch's SSCS records
and a block's singleton records): seconds a command the card was idle with it
innermost."""

from cctbench import spans


def read(cell):
    return spans.idle_per_command(cell, "sscs.emit")
