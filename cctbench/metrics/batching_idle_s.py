"""`parallel.batching` (the `batching.flush` span: bucketing a block's families and
assembling each member batch): seconds a command the card was idle with it
innermost."""

from cctbench import spans


def read(cell):
    return spans.idle_per_command(cell, "batching.flush")
