"""Observability of the port: the consensus-quality (QC) document
(:mod:`.qc`).  Import submodules directly."""
