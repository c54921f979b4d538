"""`io.columnar` sort (the `io.sort` span: a sorting writer's lexsort and
permutation at its close): seconds a command the card was idle with it
innermost."""

from cctbench import spans


def read(cell):
    return spans.idle_per_command(cell, "io.sort")
