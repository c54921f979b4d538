"""Batching: ragged UMI families -> device vote batches.

Port of ``consensuscruncher_tpu/parallel/batching.py``, both wires:

- **member stream** (the default wire): every real member row appears
  exactly once in a flat ``(M, L)`` stream, and the device derives family
  structure from the per-family sizes.  Families bucket by consensus
  length (a multiple of ``LEN_QUANTUM``) and by pow2 family-size class; a
  bucket flushes at ``MAX_BATCH`` families or ``MEMBER_LIMIT`` member rows
  (:func:`bucket_member_blocks`, the SSCS stage's).  The library's
  per-family form, :func:`bucket_members`, buckets ragged families by
  length alone.
- **dense** (``--wire dense``): each family padded into an ``(F, L)`` slot
  of a ``(B, F, L)`` batch, ``F`` the next power of two of its size, ``L``
  its length bucket; families sharing an ``(F, L)`` bucket pack up to
  ``max_batch``, and the final partial batch pads to a power of two (at
  least ``MIN_BATCH``) with size-0 slots (:func:`bucket_families`).

Rectangularization semantics (pinned; mixed-length families are rare but
legal): the family's consensus length is its **modal member length** (ties
-> longer); shorter members are padded with (N, qual 0) — N-votes count
against every real base, exactly like a low-quality-demoted base — and
longer members are truncated.  On the dense wire the cells past the
consensus length, and the unused member slots, hold (PAD, qual 0).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence

import numpy as np

from consensuscruncher_tpu_torch.obs import metrics as obs_metrics
from consensuscruncher_tpu_torch.utils.phred import N, PAD
from consensuscruncher_tpu_torch.utils.ragged import fill_runs, scatter_runs

LEN_QUANTUM = 32
MIN_BATCH = 8
MAX_BATCH = 4096
MEMBER_LIMIT = 32768


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def fam_bucket(fam_size: int) -> int:
    return max(1, next_pow2(fam_size))


def len_bucket(length: int) -> int:
    return max(LEN_QUANTUM, ((length + LEN_QUANTUM - 1) // LEN_QUANTUM) * LEN_QUANTUM)


def consensus_length(lengths: Sequence[int]) -> int:
    """Modal member length; ties resolved toward the longer length."""
    counts = Counter(sorted(lengths, reverse=True))
    return counts.most_common(1)[0][0]


def rectangularize(
    seqs: Sequence[np.ndarray], quals: Sequence[np.ndarray]
) -> tuple[np.ndarray, np.ndarray, int]:
    """Stack ragged member reads into (F, L*) arrays (see module docstring).

    Returns ``(bases, quals, consensus_length)``.
    """
    target = consensus_length([len(s) for s in seqs])
    fam = len(seqs)
    out_s = np.full((fam, target), N, dtype=np.uint8)
    out_q = np.zeros((fam, target), dtype=np.uint8)
    for j, (s, q) in enumerate(zip(seqs, quals)):
        k = min(len(s), target)
        out_s[j, :k] = s[:k]
        out_q[j, :k] = q[:k]
    return out_s, out_q, target


@dataclass
class FamilyBatch:
    """One dense device batch; ``keys[i]`` owns row ``i`` (i < n_real)."""

    keys: list
    bases: np.ndarray  # (B, F, L) uint8, PAD in unused slots
    quals: np.ndarray  # (B, F, L) uint8
    fam_sizes: np.ndarray  # (B,) int32; 0 for dummy rows
    lengths: np.ndarray  # (B,) int32 true consensus length per row

    @property
    def n_real(self) -> int:
        return len(self.keys)


class _Bucket:
    __slots__ = ("keys", "bases", "quals", "fam_sizes", "lengths")

    def __init__(self):
        self.keys, self.bases, self.quals, self.fam_sizes, self.lengths = [], [], [], [], []


def bucket_families(
    families: Iterable[tuple[object, Sequence[np.ndarray], Sequence[np.ndarray]]],
    max_batch: int = 1024,
) -> Iterator[FamilyBatch]:
    """Stream ``(key, member_seqs, member_quals)`` into padded batches.

    Emits a batch whenever a bucket fills to ``max_batch``; flushes all
    partial buckets (padded up to a power-of-two batch, min ``MIN_BATCH``)
    at the end of the stream, in ``(F, L)`` order.
    """
    buckets: dict[tuple[int, int], _Bucket] = {}
    for key, seqs, quals in families:
        if len(seqs) == 0:
            raise ValueError(f"empty family for key {key!r}")
        rect_s, rect_q, true_len = rectangularize(seqs, quals)
        fb, lb = fam_bucket(rect_s.shape[0]), len_bucket(true_len)
        padded_s = np.full((fb, lb), PAD, dtype=np.uint8)
        padded_q = np.zeros((fb, lb), dtype=np.uint8)
        padded_s[: rect_s.shape[0], :true_len] = rect_s
        padded_q[: rect_q.shape[0], :true_len] = rect_q
        bucket = buckets.setdefault((fb, lb), _Bucket())
        bucket.keys.append(key)
        bucket.bases.append(padded_s)
        bucket.quals.append(padded_q)
        bucket.fam_sizes.append(rect_s.shape[0])
        bucket.lengths.append(true_len)
        if len(bucket.keys) >= max_batch:
            yield _emit(buckets.pop((fb, lb)), fb, lb, pad_to=max_batch)
    for (fb, lb), bucket in sorted(buckets.items()):
        yield _emit(bucket, fb, lb, pad_to=None)


def _emit(bucket: _Bucket, fb: int, lb: int, pad_to: int | None) -> FamilyBatch:
    n = len(bucket.keys)
    cap = pad_to if pad_to is not None else max(MIN_BATCH, next_pow2(n))
    # padding waste at the source: every emitted device batch observes its
    # real/capacity ratio exactly once
    obs_metrics.observe("batch_occupancy", n / cap)
    bases = np.full((cap, fb, lb), PAD, dtype=np.uint8)
    quals = np.zeros((cap, fb, lb), dtype=np.uint8)
    bases[:n] = np.stack(bucket.bases)
    quals[:n] = np.stack(bucket.quals)
    fam_sizes = np.zeros(cap, dtype=np.int32)
    fam_sizes[:n] = bucket.fam_sizes
    lengths = np.zeros(cap, dtype=np.int32)
    lengths[:n] = bucket.lengths
    return FamilyBatch(
        keys=list(bucket.keys), bases=bases, quals=quals, fam_sizes=fam_sizes, lengths=lengths
    )


# Sentinel for never-written qual cells (BAM caps Phred at 93, and the
# reader maps the spec's 0xFF missing marker to 0 — 255 cannot occur live).
QUAL_FILL_SENTINEL = 255

MEMBER_QUANTUM = 1024  # member-axis padding quantum (the reference's wire layout)


@dataclass
class MemberBatch:
    """One member-stream batch; families share a length bucket ``L``.

    ``rows[start_i : start_i + sizes[i]]`` are family *i*'s members in
    insertion order (starts = exclusive cumsum of sizes).  ``sizes`` is
    padded with zeros to a static family count; ``rows``/``qrows`` are
    padded with dead rows to a MEMBER_QUANTUM multiple.  Dead cells — rows
    beyond the real member total, and positions ≥ the owning family's true
    length — hold base 0 and qual QUAL_FILL_SENTINEL; they are never
    gathered into a live family's vote, and live families' overhang
    positions are sliced off by ``lengths`` downstream, so wire encoders
    may rewrite them freely.
    """

    keys: list
    rows: np.ndarray  # (M_pad, L) uint8 base codes
    qrows: np.ndarray  # (M_pad, L) uint8 quals (QUAL_FILL_SENTINEL in dead cells)
    sizes: np.ndarray  # (NF_cap,) int32; 0 for dummy slots
    lengths: np.ndarray  # (NF_cap,) int32 true consensus length per family
    n_real: int
    n_members: int  # real member rows (before member-axis padding)


class _MemberBucket:
    __slots__ = ("keys", "rows", "qrows", "sizes", "lengths", "members")

    def __init__(self):
        self.keys, self.rows, self.qrows, self.sizes, self.lengths = [], [], [], [], []
        self.members = 0


def bucket_members(
    families: Iterable[tuple[object, Sequence[np.ndarray], Sequence[np.ndarray]]],
    max_batch: int = 1024,
    member_limit: int = 8192,
) -> Iterator[MemberBatch]:
    """Stream ``(key, member_seqs, member_quals)`` into member-stream batches.

    The rectangularization of :func:`bucket_families` (:func:`rectangularize`,
    so both wires vote the same rows), but batches bucket by length only; a
    bucket flushes when it holds ``max_batch`` families or ``member_limit``
    member rows, whichever first (one giant family flushes as its own
    batch).  The remaining buckets flush in length order at the end.
    """
    buckets: dict[int, _MemberBucket] = {}
    for key, seqs, quals in families:
        if len(seqs) == 0:
            raise ValueError(f"empty family for key {key!r}")
        rect_s, rect_q, true_len = rectangularize(seqs, quals)
        lb = len_bucket(true_len)
        bucket = buckets.setdefault(lb, _MemberBucket())
        bucket.keys.append(key)
        bucket.rows.append(rect_s)
        bucket.qrows.append(rect_q)
        bucket.sizes.append(rect_s.shape[0])
        bucket.lengths.append(true_len)
        bucket.members += rect_s.shape[0]
        if len(bucket.keys) >= max_batch or bucket.members >= member_limit:
            yield _emit_members(buckets.pop(lb), lb)
    for lb, bucket in sorted(buckets.items()):
        yield _emit_members(bucket, lb)


def _emit_members(bucket: _MemberBucket, lb: int) -> MemberBatch:
    # family axis: pow2 >= n, at least MIN_BATCH (a member_limit flush can
    # hold far fewer families than max_batch)
    n = len(bucket.keys)
    cap = max(MIN_BATCH, next_pow2(n))
    obs_metrics.observe("batch_occupancy", n / cap)
    m = bucket.members
    m_pad = max(MEMBER_QUANTUM, -(-m // MEMBER_QUANTUM) * MEMBER_QUANTUM)
    rows = np.zeros((m_pad, lb), dtype=np.uint8)
    qrows = np.full((m_pad, lb), QUAL_FILL_SENTINEL, dtype=np.uint8)
    r = 0
    for rect_s, rect_q in zip(bucket.rows, bucket.qrows):
        f, length = rect_s.shape
        rows[r:r + f, :length] = rect_s
        qrows[r:r + f, :length] = rect_q
        r += f
    sizes = np.zeros(cap, dtype=np.int32)
    sizes[:n] = bucket.sizes
    lengths = np.zeros(cap, dtype=np.int32)
    lengths[:n] = bucket.lengths
    return MemberBatch(keys=list(bucket.keys), rows=rows, qrows=qrows, sizes=sizes,
                       lengths=lengths, n_real=n, n_members=m)


class _BlockBucket:
    __slots__ = ("chunks", "keys", "sizes", "lengths", "members")

    def __init__(self):
        # each chunk: (codes_data, qual_data, mem_start, mem_len, mem_target,
        #              dst_row) — dst_row is the member's absolute row in the
        # flushed matrix, assigned at append time so per-source partitioning
        # cannot disturb family-contiguous member order.
        self.chunks = []
        self.keys: list = []
        self.sizes: list[np.ndarray] = []
        self.lengths: list[np.ndarray] = []
        self.members = 0


def bucket_member_blocks(
    items: Iterable[tuple[object, np.ndarray, list]],
    max_batch: int = MAX_BATCH,
    member_limit: int = MEMBER_LIMIT,
) -> Iterator[MemberBatch]:
    """Bucket family blocks into member-stream batches, fully array-level.

    ``items`` yields ``(block, fam_idx, keys)``: the selected families of a
    ``stages.grouping.FamilyBlock`` and their stream keys.  The module's
    rectangularization (truncate to the modal length, pad short members
    with (N, qual 0)) runs as scatter passes at flush time.  A bucket
    flushes at ``max_batch`` families or ``member_limit`` member rows.
    """
    buckets: dict[tuple[int, int], _BlockBucket] = {}

    def flush(key: tuple[int, int]) -> MemberBatch:
        lb = key[0]
        bucket = buckets.pop(key)
        n = len(bucket.keys)
        cap = max(MIN_BATCH, next_pow2(n))
        obs_metrics.observe("batch_occupancy", n / cap)
        m = bucket.members
        m_pad = max(MEMBER_QUANTUM, -(-m // MEMBER_QUANTUM) * MEMBER_QUANTUM)
        rows = np.zeros((m_pad, lb), dtype=np.uint8)
        qrows = np.full((m_pad, lb), QUAL_FILL_SENTINEL, dtype=np.uint8)
        flat_r = rows.reshape(-1)
        flat_q = qrows.reshape(-1)
        for codes_data, qual_data, mstart, mlen, mtarget, dst_row in bucket.chunks:
            dst = dst_row * lb
            minlt = np.minimum(mlen, mtarget)
            scatter_runs(flat_r, dst, codes_data, minlt, src_starts=mstart)
            scatter_runs(flat_q, dst, qual_data, minlt, src_starts=mstart)
            gap = mtarget - minlt  # short members pad with (N, qual 0)
            fill_runs(flat_r, dst + minlt, gap, N)
            fill_runs(flat_q, dst + minlt, gap, 0)
            # dead cells past target keep init values (0 / sentinel)
        sizes = np.zeros(cap, dtype=np.int32)
        lengths = np.zeros(cap, dtype=np.int32)
        sizes[:n] = np.concatenate(bucket.sizes)
        lengths[:n] = np.concatenate(bucket.lengths)
        return MemberBatch(
            keys=list(bucket.keys), rows=rows, qrows=qrows, sizes=sizes,
            lengths=lengths, n_real=n, n_members=m,
        )

    for block, fam_idx, keys in items:
        fam_idx = np.asarray(fam_idx, dtype=np.int64)
        tl = block.target_len[fam_idx]
        lbs = np.maximum(
            LEN_QUANTUM, ((tl + LEN_QUANTUM - 1) // LEN_QUANTUM) * LEN_QUANTUM
        )
        # Size-class axis: families also split by pow2 family-size class, as
        # in the reference's batching (which sizes its gather-dense member
        # cap by the class), so a batch holds families of similar depth.
        # Final output bytes are unchanged (the sorting writers' total
        # order is content-keyed, never batch order).
        szs = block.sizes[fam_idx].astype(np.int64)
        scs = np.maximum(1, 1 << np.maximum(
            0, np.int64(np.ceil(np.log2(np.maximum(szs, 1))))))
        # 40-bit class field: family sizes are int32, so sc < 2^32 always —
        # the length bucket can never be corrupted by a deep family.  The
        # extra buckets (len x ~5 size classes) pin partially-filled
        # scatter chunks a little longer, but each class still flushes on
        # the same MEMBER_LIMIT, so residency stays bounded.
        comb = lbs.astype(np.int64) << 40 | scs
        for ck in np.unique(comb):
            lb, sc = int(ck >> 40), int(ck & ((1 << 40) - 1))
            m = comb == ck
            fams = fam_idx[m]
            counts = block.sizes[fams].astype(np.int64)
            starts = block.fam_off[fams]
            tot = int(counts.sum())
            rel = np.arange(tot, dtype=np.int64) - np.repeat(
                np.concatenate([[0], np.cumsum(counts[:-1])]), counts
            )
            midx = np.repeat(starts, counts) + rel
            bucket = buckets.setdefault((lb, sc), _BlockBucket())
            dst_row = bucket.members + np.arange(tot, dtype=np.int64)
            mtarget = np.repeat(block.target_len[fams], counts)
            chunk_of = block.mem_chunk[midx]
            for ci in np.unique(chunk_of):
                cm = chunk_of == ci
                codes_data, qual_data = block.data_chunks[int(ci)]
                bucket.chunks.append((
                    codes_data, qual_data,
                    block.mem_start[midx[cm]], block.mem_len[midx[cm]],
                    mtarget[cm], dst_row[cm],
                ))
            sel = np.nonzero(m)[0]
            bucket.keys.extend(keys[int(j)] for j in sel)
            bucket.sizes.append(block.sizes[fams])
            bucket.lengths.append(block.target_len[fams])
            bucket.members += tot
            if len(bucket.keys) >= max_batch or bucket.members >= member_limit:
                yield flush((lb, sc))
    for key in sorted(buckets):
        yield flush(key)


def interleave_sources(sources: Sequence[Iterable]) -> Iterator:
    """Round-robin merge of several family streams, per-source order intact.

    The continuous-batching wire of ``serve/``: families from concurrently
    queued jobs are drawn one per source per round, so a single
    :func:`bucket_families` stream packs work from every live job into the
    same device buckets.  Per-source relative order is exactly the
    source's own, which is the invariant the byte-identical guarantee
    rests on: packed family content is source-local (``rectangularize``
    sees one family at a time), and every downstream writer orders output
    by a content-keyed sort, never by batch order.  Exhausted sources drop
    out; the merge ends when all are exhausted.
    """
    iters = [iter(s) for s in sources]
    while iters:
        alive = []
        for it in iters:
            try:
                yield next(it)
            except StopIteration:
                continue
            alive.append(it)
        iters = alive
