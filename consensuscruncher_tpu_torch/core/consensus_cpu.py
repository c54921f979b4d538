"""Consensus defaults, the exact rational cutoff and the family oracle.

Port of ``consensuscruncher_tpu/core/consensus_cpu.py`` (the constants,
:func:`cutoff_fraction`, :func:`consensus_maker` and
:func:`consensus_maker_numpy`), whose docstring pins the
vote's semantics (reference parity target:
``ConsensusCruncher/consensus_helper.py:consensus_maker``).  Per position
over a family of ``F`` reads: a read whose qual is below ``qual_threshold``
votes N; the modal effective base wins, ties to the earliest first-seen
read; the vote passes iff ``count * den >= num * F`` with ``cutoff = num /
den`` exact; a passing non-N modal base keeps ``min(sum of agreeing quals,
qual_cap)``, anything else is ``(N, 0)``.
"""

from __future__ import annotations

from collections import Counter
from fractions import Fraction

import numpy as np

from consensuscruncher_tpu_torch.utils.phred import N, NUM_BASES

DEFAULT_CUTOFF = 0.7
DEFAULT_QUAL_CAP = 60
DEFAULT_QUAL_THRESHOLD = 0


def cutoff_fraction(cutoff: float) -> tuple[int, int]:
    """Exact rational ``(num, den)`` for a float cutoff.

    ``limit_denominator(1000)`` recovers the human-entered decimal (0.7 ->
    7/10, and 0.333... -> 1/3) rather than the float's binary expansion, so
    the integer comparison ``count * den >= num * F`` matches the intent of
    ``count/F >= cutoff``.  The small denominator bound also keeps the
    cross-multiply int32-safe on device for families up to ~2M reads.
    """
    frac = Fraction(cutoff).limit_denominator(1000)
    return frac.numerator, frac.denominator


def _validate_family(seqs: np.ndarray, quals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Un-padded ``(F, L)`` code arrays with codes in A..N (0..4): PAD (5)
    is a layout artifact the batching layers mask before consensus."""
    seqs = np.asarray(seqs, dtype=np.uint8)
    quals = np.asarray(quals, dtype=np.uint8)
    if seqs.ndim != 2 or seqs.shape != quals.shape:
        raise ValueError(f"seqs/quals must be matching (F, L) arrays, got {seqs.shape}/{quals.shape}")
    if seqs.shape[0] == 0:
        raise ValueError("empty family")
    if seqs.size and seqs.max() > N:
        raise ValueError("base codes above N (4) — strip PAD before consensus")
    return seqs, quals


def consensus_maker(
    seqs: np.ndarray,
    quals: np.ndarray,
    cutoff: float = DEFAULT_CUTOFF,
    qual_threshold: int = DEFAULT_QUAL_THRESHOLD,
    qual_cap: int = DEFAULT_QUAL_CAP,
) -> tuple[np.ndarray, np.ndarray]:
    """Collapse one UMI family (``(F, L)`` uint8 base codes and Phred
    quals, one row per member) to ``(consensus_codes, consensus_quals)``,
    two ``(L,)`` uint8 arrays: the readable per-position Counter loop, the
    oracle the kernels are held to."""
    seqs, quals = _validate_family(seqs, quals)
    fam, length = seqs.shape
    num, den = cutoff_fraction(cutoff)

    out_base = np.full(length, N, dtype=np.uint8)
    out_qual = np.zeros(length, dtype=np.uint8)

    for i in range(length):
        counter: Counter = Counter()
        for j in range(fam):
            b = seqs[j, i]
            eff = N if quals[j, i] < qual_threshold else int(b)
            counter[eff] += 1
        modal, count = counter.most_common(1)[0]
        if modal != N and count * den >= num * fam:
            qsum = 0
            for j in range(fam):
                if seqs[j, i] == modal and quals[j, i] >= qual_threshold:
                    qsum += int(quals[j, i])
            out_base[i] = modal
            out_qual[i] = min(qsum, qual_cap)
    return out_base, out_qual


def consensus_maker_numpy(
    seqs: np.ndarray,
    quals: np.ndarray,
    cutoff: float = DEFAULT_CUTOFF,
    qual_threshold: int = DEFAULT_QUAL_THRESHOLD,
    qual_cap: int = DEFAULT_QUAL_CAP,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized twin of :func:`consensus_maker`, bit-identical to it: the
    vote of ``consensus --backend cpu``.  One-hot counts per position, the
    first-seen member index as the tie-break, the exact rational cutoff."""
    seqs, quals = _validate_family(seqs, quals)
    fam, _length = seqs.shape
    num, den = cutoff_fraction(cutoff)

    eff = np.where(quals < qual_threshold, np.uint8(N), seqs)  # (F, L)
    onehot = eff[:, :, None] == np.arange(NUM_BASES, dtype=np.uint8)  # (F, L, 5)
    counts = onehot.sum(axis=0, dtype=np.int64)  # (L, 5)
    member_idx = np.arange(fam, dtype=np.int64)[:, None, None]
    first_seen = np.where(onehot, member_idx, fam).min(axis=0)  # (L, 5)
    # (count desc, first_seen asc) as one integer score: no ties, since
    # first-seen indexes are distinct
    score = counts * (fam + 1) + (fam - first_seen)
    modal = score.argmax(axis=1)
    modal_count = np.take_along_axis(counts, modal[:, None], axis=1)[:, 0]
    passed = (modal != N) & (modal_count * den >= num * fam)
    # quals of the reads whose own base is the modal base and passes the
    # threshold: for a non-N modal base, exactly the agreeing effective votes
    agree = (seqs == modal[None, :].astype(np.uint8)) & (quals >= qual_threshold)
    qsum = np.where(agree, quals.astype(np.int64), 0).sum(axis=0)
    out_base = np.where(passed, modal, N).astype(np.uint8)
    out_qual = np.where(passed, np.minimum(qsum, qual_cap), 0).astype(np.uint8)
    return out_base, out_qual
