"""`io.columnar` decode (the `io.decode` span: a batch's BGZF read, inflate and
record scan): seconds a command the card was idle with it innermost."""

from cctbench import spans


def read(cell):
    return spans.idle_per_command(cell, "io.decode")
