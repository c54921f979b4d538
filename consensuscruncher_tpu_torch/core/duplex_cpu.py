"""Host oracle of the duplex vote and the singleton correction.

Port of ``consensuscruncher_tpu/core/duplex_cpu.py`` (reference parity:
``ConsensusCruncher/DCS_maker.py:duplex_consensus`` and the per-base
correction of ``singleton_correction.py``).  Per position ``i`` of two
strand sequences: the base is kept iff both strands agree on it and it is
not N, with quality ``min(q1[i] + q2[i], qual_cap)``; anything else is
``(N, 0)``.  A singleton corrected against its complementary-strand
partner is exactly a 2-deep duplex vote, so one formula serves both.  The
port's stages vote in batches through ``ops.duplex`` (on the card, or its
plain torch form on the CPU); this per-read numpy form is the reference
the tests hold those batches to.
"""

from __future__ import annotations

import numpy as np

from consensuscruncher_tpu_torch.core.consensus_cpu import DEFAULT_QUAL_CAP
from consensuscruncher_tpu_torch.utils.phred import N


def duplex_consensus(
    seq1: np.ndarray,
    qual1: np.ndarray,
    seq2: np.ndarray,
    qual2: np.ndarray,
    qual_cap: int = DEFAULT_QUAL_CAP,
) -> tuple[np.ndarray, np.ndarray]:
    """Elementwise two-strand agreement vote over four ``(L,)`` uint8
    arrays (base codes / Phred scores) -> ``(codes, quals)``."""
    seq1 = np.asarray(seq1, dtype=np.uint8)
    seq2 = np.asarray(seq2, dtype=np.uint8)
    qual1 = np.asarray(qual1, dtype=np.uint8)
    qual2 = np.asarray(qual2, dtype=np.uint8)
    if not (seq1.shape == seq2.shape == qual1.shape == qual2.shape):
        raise ValueError("duplex inputs must share one (L,) shape")
    if (seq1.size and seq1.max() > N) or (seq2.size and seq2.max() > N):
        raise ValueError("base codes above N (4) — strip PAD before duplex consensus")
    agree = (seq1 == seq2) & (seq1 < N)
    out_base = np.where(agree, seq1, np.uint8(N))
    qsum = qual1.astype(np.int64) + qual2.astype(np.int64)
    out_qual = np.where(agree, np.minimum(qsum, qual_cap), 0).astype(np.uint8)
    return out_base, out_qual


correct_singleton = duplex_consensus
