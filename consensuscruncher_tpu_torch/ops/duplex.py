"""Duplex vote (reference: ``DCS_maker.py:duplex_consensus``).

Port of ``consensuscruncher_tpu/ops/duplex_tpu.py``: an elementwise
two-strand agreement vote over ``(B, L)`` planes — keep agreeing non-N
bases with summed, capped quality, anything else is ``(N, 0)``.  Used for
DCS and for singleton rescue (a correction is a 2-deep duplex vote).  An
XLA program in the JAX package, so elementwise torch ops on the chosen
device here.  :func:`duplex_batch` is the reference's bucketed batch
call (the stages vote through :func:`duplex_batch_host`, unpadded).
"""

from __future__ import annotations

import numpy as np
import torch

from consensuscruncher_tpu_torch.core.consensus_cpu import DEFAULT_QUAL_CAP
from consensuscruncher_tpu_torch.device import resolve_device
from consensuscruncher_tpu_torch.obs import metrics as obs_metrics
from consensuscruncher_tpu_torch.utils.phred import N


def duplex_vote(seq1, qual1, seq2, qual2, *, qual_cap: int = DEFAULT_QUAL_CAP,
                agree_mask=None):
    """The pinned duplex formula on uint8 tensors; ``agree_mask``
    optionally vetoes agreement (e.g. batch slots lacking a strand)."""
    agree = (seq1 == seq2) & (seq1 < N)
    if agree_mask is not None:
        agree = agree & agree_mask
    out_base = torch.where(agree, seq1, N).to(torch.uint8)
    qsum = qual1.to(torch.int32) + qual2.to(torch.int32)
    out_qual = torch.where(agree, qsum.clamp(max=qual_cap), 0).to(torch.uint8)
    return out_base, out_qual


def duplex_batch(seq1, qual1, seq2, qual2, qual_cap: int = DEFAULT_QUAL_CAP,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Batched duplex vote at the JAX package's bucketed shape: four host
    ``(B, L)`` uint8 arrays, zero-padded to ``(Bp, Lp)`` (``Bp`` the next
    power of two of ``B``, ``Lp`` the batching layer's length bucket), ->
    one stacked ``(2, Bp, Lp)`` uint8 tensor on ``device`` (default: the
    card); callers slice ``[:, :B, :L]``."""
    from consensuscruncher_tpu_torch.parallel.batching import len_bucket, next_pow2

    dev = resolve_device(device)
    b = int(np.shape(seq1)[0]) if np.ndim(seq1) else 0
    length = int(np.shape(seq1)[1]) if np.ndim(seq1) > 1 else 0
    bp, lp = next_pow2(b), len_bucket(length)
    planes = []
    for x in (seq1, qual1, seq2, qual2):
        p = np.zeros((bp, lp), np.uint8)
        p[:b, :length] = np.asarray(x, dtype=np.uint8)
        planes.append(torch.from_numpy(p).to(dev))
    obs_metrics.note_transfer("h2d", sum(p.nbytes for p in planes), dev)
    return torch.stack(duplex_vote(*planes, qual_cap=int(qual_cap)))


def duplex_batch_host(seq1, qual1, seq2, qual2, qual_cap: int = DEFAULT_QUAL_CAP,
                      device: torch.device | str | None = None):
    """Four host ``(B, L)`` uint8 arrays -> duplex ``(bases, quals)`` host
    arrays, voted on ``device`` (default: the CUDA card, which must exist;
    the CPU only when asked for)."""
    dev = resolve_device(device)
    planes = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(dev)
              for x in (seq1, qual1, seq2, qual2)]
    obs_metrics.note_transfer("h2d", sum(p.nbytes for p in planes), dev)
    out_b, out_q = duplex_vote(*planes, qual_cap=int(qual_cap))
    obs_metrics.note_transfer("d2h", out_b.nbytes + out_q.nbytes, dev)
    return out_b.cpu().numpy(), out_q.cpu().numpy()
