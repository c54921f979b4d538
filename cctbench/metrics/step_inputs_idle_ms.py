"""`parallel.mesh` step inputs (the `mesh.inputs` span: a shard's views, the
strands joined, the sizes and starts): milliseconds a step the card was idle
with it innermost."""

from cctbench import spans


def read(cell):
    return spans.idle_ms_per_step(cell, "mesh.inputs")
