"""Synthetic duplex-sequencing dataset generator (benchmark-scale data).

Port of ``consensuscruncher_tpu/utils/simulate.py``: ``SimConfig``, the
per-read generator ``simulate_bam`` (with the degraded-read regime the
vote policies are judged on) and the vectorized ``simulate_bam_fast``
(benchmark scale; no degraded regime, as in the reference).  It
fabricates duplex fragments the same way the wet lab does: a true
molecule sequence, two strands, R1/R2 per strand, per-read sequencing
errors, barcodes recorded in swapped order on opposite strands (see
core/tags.py's physical model).  Numpy only, seeded by ``SimConfig.seed``:
the same config writes the same BAM as the JAX package's generator.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from consensuscruncher_tpu_torch.core.tags import BARCODE_SEP, DEFAULT_BDELIM
from consensuscruncher_tpu_torch.io.bam import BamHeader, BamRead, BamWriter, sort_bam

BASES = "ACGT"


@dataclass
class SimConfig:
    n_fragments: int = 100
    read_len: int = 100
    umi_len: int = 6
    ref_len: int = 100_000
    ref_name: str = "chr1"
    mean_family_size: float = 3.0
    duplex_fraction: float = 0.8  # fraction of fragments with both strands
    error_rate: float = 0.005
    # Per-read probability of one substitution error INSIDE the UMI — such
    # reads split off as spurious singleton families whose barcode is
    # Hamming-1 from the true family's, the exact population
    # --max_mismatch rescue exists to reclaim.
    barcode_error_rate: float = 0.0
    # Low-quality regime (``simulate_bam`` only): each read independently
    # degrades with this probability — its Phred scores drop into
    # ``degraded_qual`` (below the delegation policy's Phred-20 floor; the
    # healthy band at 25-40 stays above it) and its bases pick up extra
    # substitutions at ``degraded_error_rate`` on top of ``error_rate``.
    # No draw is made at rate 0, so the rng stream is unchanged by default.
    degraded_read_rate: float = 0.0
    degraded_error_rate: float = 0.08
    degraded_qual: tuple = (3, 16)
    seed: int = 0
    bdelim: str = DEFAULT_BDELIM


@dataclass
class SimTruth:
    """Ground truth of ``simulate_bam``: fragment -> molecule sequence and
    family sizes."""

    molecules: dict = field(default_factory=dict)  # frag id -> (start, seq)
    family_sizes: dict = field(default_factory=dict)  # frag id -> (a_size, b_size)


def _rand_seq(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def _mutate(rng, seq: str, rate: float) -> str:
    if rate <= 0:
        return seq
    arr = list(seq)
    for i in np.nonzero(rng.random(len(arr)) < rate)[0]:
        arr[i] = BASES[int(rng.integers(0, 4))]
    return "".join(arr)


def simulate_bam(path: str, cfg: SimConfig) -> SimTruth:
    """Write a coordinate-sorted, barcode-extracted BAM of duplex families,
    one read at a time (test-fixture scale), and return its truth."""
    rng = np.random.default_rng(cfg.seed)
    header = BamHeader.from_refs([(cfg.ref_name, cfg.ref_len)])
    truth = SimTruth()
    tmp = path + ".unsorted"
    serial = 0
    with BamWriter(tmp, header) as w:
        for frag in range(cfg.n_fragments):
            lo = int(rng.integers(1000, cfg.ref_len - 3 * cfg.read_len))
            hi = lo + 2 * cfg.read_len + int(rng.integers(0, cfg.read_len))
            mol = _rand_seq(rng, hi + cfg.read_len - lo)
            umi_a = _rand_seq(rng, cfg.umi_len)
            umi_b = _rand_seq(rng, cfg.umi_len)
            a_size = max(1, int(rng.poisson(cfg.mean_family_size)))
            b_size = (max(1, int(rng.poisson(cfg.mean_family_size)))
                      if rng.random() < cfg.duplex_fraction else 0)
            truth.molecules[frag] = (lo, mol)
            truth.family_sizes[frag] = (a_size, b_size)
            r1_seq = mol[: cfg.read_len]
            r2_seq = mol[hi - lo: hi - lo + cfg.read_len]
            for strand, size in (("A", a_size), ("B", b_size)):
                bc = (f"{umi_a}{BARCODE_SEP}{umi_b}" if strand == "A"
                      else f"{umi_b}{BARCODE_SEP}{umi_a}")
                for _ in range(size):
                    serial += 1
                    bc_read = bc
                    # no draw at rate 0: the rng stream of older datasets
                    if cfg.barcode_error_rate > 0 and rng.random() < cfg.barcode_error_rate:
                        chars = list(bc_read)
                        pool = [i for i, c in enumerate(chars) if c != BARCODE_SEP]
                        i = pool[int(rng.integers(0, len(pool)))]
                        chars[i] = BASES[(BASES.index(chars[i]) + 1
                                          + int(rng.integers(0, 3))) % 4]
                        bc_read = "".join(chars)
                    qname = f"sim:{frag}:{strand}:{serial}{cfg.bdelim}{bc_read}"
                    s1 = _mutate(rng, r1_seq, cfg.error_rate)
                    s2 = _mutate(rng, r2_seq, cfg.error_rate)
                    q1 = rng.integers(25, 41, cfg.read_len).astype(np.uint8)
                    q2 = rng.integers(25, 41, cfg.read_len).astype(np.uint8)
                    if cfg.degraded_read_rate > 0 and rng.random() < cfg.degraded_read_rate:
                        qlo, qhi = cfg.degraded_qual
                        s1 = _mutate(rng, s1, cfg.degraded_error_rate)
                        s2 = _mutate(rng, s2, cfg.degraded_error_rate)
                        q1 = rng.integers(qlo, qhi, cfg.read_len).astype(np.uint8)
                        q2 = rng.integers(qlo, qhi, cfg.read_len).astype(np.uint8)
                    # strand A: R1 fwd@lo / R2 rev@hi ; strand B mirrored
                    r1_read1 = strand == "A"
                    w.write(BamRead(
                        qname=qname, flag=(0x1 | 0x2 | 0x20 | (0x40 if r1_read1 else 0x80)),
                        ref=cfg.ref_name, pos=lo, mapq=60, cigar=[("M", cfg.read_len)],
                        mate_ref=cfg.ref_name, mate_pos=hi, tlen=hi - lo + cfg.read_len,
                        seq=s1, qual=q1))
                    w.write(BamRead(
                        qname=qname, flag=(0x1 | 0x2 | 0x10 | (0x80 if r1_read1 else 0x40)),
                        ref=cfg.ref_name, pos=hi, mapq=60, cigar=[("M", cfg.read_len)],
                        mate_ref=cfg.ref_name, mate_pos=lo, tlen=-(hi - lo + cfg.read_len),
                        seq=s2, qual=q2))
    sort_bam(tmp, path)
    os.unlink(tmp)
    return truth


def _mix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer: uint64 array -> well-mixed uint64 array."""
    z = x + np.uint64(0x9E3779B97F4A7C15)
    z ^= z >> np.uint64(30)
    z *= np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(27)
    z *= np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(31)
    return z


@dataclass
class SimTruthFast:
    """Array-form ground truth from ``simulate_bam_fast`` (no per-fragment
    dicts — at benchmark scale those would dominate memory)."""

    lo: np.ndarray
    hi: np.ndarray
    a_size: np.ndarray
    b_size: np.ndarray

    @property
    def n_reads(self) -> int:
        return 2 * int(self.a_size.sum() + self.b_size.sum())


def simulate_bam_fast(
    path: str, cfg: SimConfig, chunk_reads: int = 2_000_000, level: int = 6
) -> SimTruthFast:
    """Write a coordinate-sorted, barcode-extracted BAM of duplex families.

    Statistical model (fragment endpoints, Poisson family sizes, duplex
    dropout, per-base substitution errors, swapped-half barcodes), but the
    whole dataset is a pure function of ``(cfg.seed, chunk_reads)``:
    per-fragment draws are vectorized ``default_rng`` arrays, family
    templates derive from a counter-based SplitMix64 stream (chunk-
    independent), and per-read errors/quals burn the sequential rng stream
    chunk by chunk — so ``chunk_reads`` is part of the dataset identity;
    keep the default when regenerating a dataset byte-for-byte.  Reads are emitted directly
    in coordinate order (sort key: pos, qname, flag — same total order as
    ``sort_bam`` on a single-ref BAM) and encoded with the vectorized
    ``encode_records`` path, so there is no unsorted temp file and no
    object-path encode.

    ``cfg.barcode_error_rate`` is supported: affected reads get one UMI base
    substituted, splitting them into Hamming-1 singleton families.
    """
    from consensuscruncher_tpu_torch.io.bam import _sorted_header
    from consensuscruncher_tpu_torch.io.encode import encode_records

    rng = np.random.default_rng(cfg.seed)
    L, U = cfg.read_len, cfg.umi_len
    nF = cfg.n_fragments
    if cfg.ref_len < 1000 + 4 * L:
        raise ValueError("ref_len too small for read placement")

    # --- per-fragment draws (vectorized; one vectorized stream) ---
    lo = rng.integers(1000, cfg.ref_len - 3 * L, nF, dtype=np.int64)
    hi = lo + 2 * L + rng.integers(0, L, nF, dtype=np.int64)
    umi_a = rng.integers(0, 4, (nF, U), dtype=np.int8).astype(np.uint8)
    umi_b = rng.integers(0, 4, (nF, U), dtype=np.int8).astype(np.uint8)
    a_size = np.maximum(1, rng.poisson(cfg.mean_family_size, nF)).astype(np.int32)
    duplex = rng.random(nF) < cfg.duplex_fraction
    b_size = np.where(
        duplex, np.maximum(1, rng.poisson(cfg.mean_family_size, nF)), 0
    ).astype(np.int32)

    # --- member table (frag-major, strand A then B) ---
    counts = (a_size + b_size).astype(np.int64)
    M = int(counts.sum())
    frag_of = np.repeat(np.arange(nF, dtype=np.int64), counts)
    starts = np.zeros(nF, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    idx_in_frag = np.arange(M, dtype=np.int64) - starts[frag_of]
    strand_b = idx_in_frag >= a_size[frag_of]

    # barcode errors: one substituted UMI base on the read's recorded barcode
    if cfg.barcode_error_rate > 0:
        bc_err = rng.random(M) < cfg.barcode_error_rate
        bc_err_pos = rng.integers(0, 2 * U, M, dtype=np.int64)
        bc_err_delta = rng.integers(1, 4, M, dtype=np.uint8)
    else:
        bc_err = np.zeros(M, dtype=bool)
        bc_err_pos = bc_err_delta = None

    # --- read table (2 reads per member) + global coordinate order ---
    n_reads = 2 * M
    frag_r = np.repeat(frag_of, 2)
    readno = np.tile(np.array([0, 1], dtype=np.int64), M)
    pos_r = np.where(readno == 0, lo[frag_r], hi[frag_r])
    # sort_bam's total order on one ref: (pos, qname bytes, flag).  qnames
    # are fixed-width with zero-padded digits, so lexicographic qname order
    # == (frag, strand, serial) numeric order; serial == member index, which
    # frag-major layout already encodes.  flag ordering within a pair:
    # both reads share the qname, readno 0 vs 1 differ only in flag, and
    # flags below are chosen so read0's flag < read1's on strand A
    # (0x63 < 0x93) while strand B needs the swap (0xA3 > 0x53).
    member_r = np.repeat(np.arange(M, dtype=np.int64), 2)
    flag_key = np.where(
        strand_b[member_r], 1 - readno, readno
    )
    perm = np.lexsort((flag_key, member_r, pos_r))

    seed64 = np.uint64(np.int64(cfg.seed)) ^ np.uint64(0xC0FFEE5EED)
    qname_w = 4 + 9 + 1 + 1 + 1 + 9 + len(cfg.bdelim) + (2 * U + len(BARCODE_SEP))
    digits0 = np.uint8(ord("0"))
    base_bytes = np.frombuffer(BASES.encode(), np.uint8)
    sep_bytes = np.frombuffer(BARCODE_SEP.encode(), np.uint8)
    bdelim_bytes = np.frombuffer(cfg.bdelim.encode(), np.uint8)

    header = _sorted_header(BamHeader.from_refs([(cfg.ref_name, cfg.ref_len)]))
    writer = BamWriter(path, header, atomic=True, level=level)
    try:
        for c0 in range(0, n_reads, chunk_reads):
            ridx = perm[c0 : c0 + chunk_reads]
            C = len(ridx)
            mem = member_r[ridx]
            frag = frag_of[mem]
            rno = readno[ridx]
            sb = strand_b[mem]

            # flags / coords (strand A: read0 fwd@lo R1, read1 rev@hi R2;
            # strand B: read0 fwd@lo R2, read1 rev@hi R1)
            flags = np.where(
                rno == 0,
                np.where(sb, 0xA3, 0x63),
                np.where(sb, 0x53, 0x93),
            ).astype(np.int64)
            p = np.where(rno == 0, lo[frag], hi[frag])
            mp = np.where(rno == 0, hi[frag], lo[frag])
            span = hi[frag] - lo[frag] + L
            tlen = np.where(rno == 0, span, -span)

            # sequence codes: per-(frag, readno) template + per-read errors.
            # The template must be identical wherever a family member lands
            # (members of one family can straddle chunk boundaries), so it is
            # a counter-based hash of (frag, readno, position) — computed
            # once per UNIQUE row in the chunk, then gathered.  Per-read
            # draws (errors, quals) burn the sequential rng stream instead:
            # each read is emitted exactly once in deterministic order, so
            # the stream is reproducible without keyed hashing.
            jj = np.arange(L, dtype=np.uint64)
            uniq, inv = np.unique(frag * 2 + rno, return_inverse=True)
            tk = (uniq.astype(np.uint64) * np.uint64(L))[:, None] + jj[None, :]
            codes = (_mix64(tk ^ seed64) & np.uint64(3)).astype(np.uint8)[inv]
            if cfg.error_rate > 0:
                # Sparse error placement: k ~ Binomial(C*L, rate) positions
                # drawn with replacement (collisions are ~rate^2-rare), vs a
                # dense float draw over every base.
                k = rng.binomial(C * L, cfg.error_rate)
                epos = rng.integers(0, C * L, k)
                codes = np.ascontiguousarray(codes)
                codes.ravel()[epos] = rng.integers(0, 4, k, dtype=np.uint8)
            quals = rng.integers(25, 41, (C, L), dtype=np.uint8)

            # qnames: "sim:FFFFFFFFF:S:MMMMMMMMM<bdelim><bc1>.<bc2>"
            qm = np.empty((C, qname_w), dtype=np.uint8)
            qm[:, 0:4] = np.frombuffer(b"sim:", np.uint8)
            col = 4
            f10 = frag.copy()
            for d in range(8, -1, -1):
                qm[:, col + d] = digits0 + (f10 % 10).astype(np.uint8)
                f10 //= 10
            col += 9
            qm[:, col] = ord(":")
            col += 1
            qm[:, col] = np.where(sb, ord("B"), ord("A"))
            col += 1
            qm[:, col] = ord(":")
            col += 1
            m10 = mem + 1  # serial: 1-based member id (unique, stable)
            for d in range(8, -1, -1):
                qm[:, col + d] = digits0 + (m10 % 10).astype(np.uint8)
                m10 //= 10
            col += 9
            qm[:, col : col + len(bdelim_bytes)] = bdelim_bytes
            col += len(bdelim_bytes)
            # barcode halves in strand order (A: a.b, B: b.a)
            left = np.where(sb[:, None], umi_b[frag], umi_a[frag])
            right = np.where(sb[:, None], umi_a[frag], umi_b[frag])
            bc = np.empty((C, 2 * U), dtype=np.uint8)
            bc[:, :U] = left
            bc[:, U:] = right
            if bc_err.any():
                hit = np.nonzero(bc_err[mem])[0]
                if hit.size:
                    ppos = bc_err_pos[mem[hit]]
                    bc[hit, ppos] = (bc[hit, ppos] + bc_err_delta[mem[hit]]) % 4
            qm[:, col : col + U] = base_bytes[bc[:, :U]]
            qm[:, col + U : col + U + len(sep_bytes)] = sep_bytes
            qm[:, col + U + len(sep_bytes) :] = base_bytes[bc[:, U:]]

            blob = encode_records(
                qm.ravel(),
                np.full(C, qname_w, np.int64),
                flags,
                np.zeros(C, np.int64),
                p.astype(np.int64),
                np.full(C, 60, np.int64),
                np.full(C, (L << 4) | 0, np.uint32),
                np.ones(C, np.int64),
                np.zeros(C, np.int64),
                mp.astype(np.int64),
                tlen.astype(np.int64),
                codes.ravel(),
                np.full(C, L, np.int64),
                quals.ravel(),
                np.empty(0, np.uint8),
                np.zeros(C, np.int64),
            )
            writer.write_encoded(blob)
        writer.close()
    except BaseException:
        writer.abort()
        raise
    return SimTruthFast(lo=lo, hi=hi, a_size=a_size, b_size=b_size)
