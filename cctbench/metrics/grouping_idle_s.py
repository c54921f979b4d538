"""`stages.grouping` (the `grouping.block` span: classifying a batch and building a
family, pair or rescue block): seconds a command the card was idle with it
innermost."""

from cctbench import spans


def read(cell):
    return spans.idle_per_command(cell, "grouping.block")
