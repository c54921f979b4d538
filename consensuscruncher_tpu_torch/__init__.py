"""consensuscruncher_tpu_torch — the PyTorch/CUDA port of consensuscruncher_tpu.

A second implementation of the UMI duplex-sequencing consensus pipeline,
beside the JAX package (which stays the reference).  The port imports
``torch`` and never ``jax``, and keeps its own copies of the host modules
(``io/``, ``core/``, ``utils/``, ``stages/grouping``, ``parallel/batching``)
under the reference's module names.

Ported so far: ``consensus --scorrect True`` on the staged pipeline and
on the streaming one (``--pipeline streaming``) — the SSCS vote over the
packed member-stream wire with its QC rider (a hand-written CUDA kernel,
``csrc/consensus_vote.cu``), the vectorized singleton rescue, DCS, the
all-unique merges, the BAI indexes, and the run's ``qc.json``,
``manifest.json`` (``--resume``) and ``run.metrics.json``; the vote
policies (``--policy majority|delegation|distilled``, ``policies/``); and
the fused SSCS+DCS API.  Entry points run on the CUDA card
unless the caller asks for the CPU (``device="cpu"``, ``--device cpu``),
where each kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"
