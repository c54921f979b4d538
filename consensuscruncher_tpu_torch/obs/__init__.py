"""Observability of the port: the consensus-quality (QC) document
(:mod:`.qc`), the transfer-byte and build counters (:mod:`.metrics`) and
the counter names of the metrics sidecars (:mod:`.registry`).  Import
submodules directly."""
