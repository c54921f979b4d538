"""`io.bgzf` deflate (the `io.deflate` span: a sorting writer's BGZF write at its
close, with the wait on the write-behind worker and the inline index):
seconds a command the card was idle with it innermost."""

from cctbench import spans


def read(cell):
    return spans.idle_per_command(cell, "io.deflate")
