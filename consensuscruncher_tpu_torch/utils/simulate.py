"""Synthetic duplex-sequencing dataset generator (benchmark-scale data).

Port of ``consensuscruncher_tpu/utils/simulate.py``: ``SimConfig``, the
per-read generator ``simulate_bam`` (with the degraded-read regime the
vote policies are judged on) and the vectorized ``simulate_bam_fast``
(benchmark scale; no degraded regime, as in the reference),
``simulate_bam_adversarial`` (the edge-case BAM: clips, ambiguity bases,
flag soup, reference edges) and ``simulate_fastq_pairs`` (raw FASTQ pairs
and their FASTA reference for ``fastq2bam``).  It fabricates duplex fragments the same way the wet lab
does: a true molecule sequence, two strands, R1/R2 per strand, per-read
sequencing errors, barcodes recorded in swapped order on opposite strands
(see core/tags.py's physical model).  Numpy only, seeded by ``SimConfig.seed``:
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


def simulate_bam_adversarial(path: str, seed: int = 0,
                             bdelim: str = DEFAULT_BDELIM) -> dict:
    """Write a small coordinate-sorted barcoded BAM stuffed with the edge
    cases real sequencing data throws at a pipeline (the generator behind
    ``test/data/sample_adversarial.bam``): indel/soft-clip/hard-clip cigars,
    mixed and odd read lengths inside one family, ambiguity bases, missing
    quals, exotic-but-legal tag types, long qnames, flag soup
    (secondary/supplementary/qcfail/duplicate), placed-unmapped mates and
    fully-unplaced pairs, families anchored at position 0 and at the
    reference edge.

    Returns a dict of expected stage-routing counts for assertions:
    ``bad_reads`` (reads the SSCS stage must route to badReads.bam) and
    ``good_reads`` (reads that must enter family grouping).
    """
    rng = np.random.default_rng(seed)
    ref_name, ref_len = "chrAdv", 400_000
    header = BamHeader.from_refs([(ref_name, ref_len)])
    reads: list[BamRead] = []
    expect = {"bad_reads": 0, "good_reads": 0}

    def qual(n, lo=25, hi=41):
        return rng.integers(lo, hi, n).astype(np.uint8)

    def add_pair(qname, pos, mpos, seq1, seq2, cigar1, cigar2, flag_extra1=0,
                 flag_extra2=0, q1=None, q2=None, tags1=None, tags2=None,
                 good=True, r1_first=True):
        # r1_first mirrors simulate_bam's strand model: strand A reads are
        # (read1 fwd @ pos, read2 rev @ mpos); the complementary strand B
        # flips the read-number bits — the flip the duplex tag pairs on.
        tlen = mpos - pos + len(seq2)
        reads.append(BamRead(
            qname=qname,
            flag=0x1 | 0x2 | 0x20 | (0x40 if r1_first else 0x80) | flag_extra1,
            ref=ref_name, pos=pos, mapq=60, cigar=cigar1,
            mate_ref=ref_name, mate_pos=mpos, tlen=tlen,
            seq=seq1, qual=qual(len(seq1)) if q1 is None else q1,
            tags=dict(tags1 or {}),
        ))
        reads.append(BamRead(
            qname=qname,
            flag=0x1 | 0x2 | 0x10 | (0x80 if r1_first else 0x40) | flag_extra2,
            ref=ref_name, pos=mpos, mapq=60, cigar=cigar2,
            mate_ref=ref_name, mate_pos=pos, tlen=-tlen,
            seq=seq2, qual=qual(len(seq2)) if q2 is None else q2,
            tags=dict(tags2 or {}),
        ))
        bad_flags = 0x4 | 0x8 | 0x100 | 0x200 | 0x800
        for fx in (flag_extra1, flag_extra2):
            if good and not (fx & bad_flags):
                expect["good_reads"] += 1
            else:
                expect["bad_reads"] += 1

    def bc(u1, u2):
        return f"{u1}{BARCODE_SEP}{u2}"

    serial = 0

    def qn(tag, barcode, extra=""):
        nonlocal serial
        serial += 1
        return f"adv:{tag}:{serial}{extra}{bdelim}{barcode}"

    # 1. plain duplex families (baseline population, incl. one at pos 0 and
    #    one at the reference edge)
    for i, lo in enumerate([0, 5_000, 12_345, ref_len - 260]):
        hi = lo + 150
        u1, u2 = _rand_seq(rng, 6), _rand_seq(rng, 6)
        mol1, mol2 = _rand_seq(rng, 100), _rand_seq(rng, 100)
        for strand, barcode in (("A", bc(u1, u2)), ("B", bc(u2, u1))):
            for _ in range(3):
                name = qn(f"base{i}{strand}", barcode)
                add_pair(name, lo, hi, mol1, mol2,
                         [("M", 100)], [("M", 100)], r1_first=strand == "A")

    # 2. indel/clip cigar families: query-consuming ops sum to seq length;
    #    members disagree on cigar (modal-cigar path) and lengths vary
    u1, u2 = _rand_seq(rng, 6), _rand_seq(rng, 6)
    mol1, mol2 = _rand_seq(rng, 100), _rand_seq(rng, 100)
    cigs = [
        [("S", 5), ("M", 90), ("S", 5)],
        [("M", 40), ("I", 4), ("M", 56)],
        [("M", 30), ("D", 7), ("M", 70)],
        [("H", 12), ("M", 100)],
        [("M", 25), ("N", 500), ("M", 75)],
    ]
    for k, cig in enumerate(cigs):
        name = qn("indel", bc(u1, u2))
        add_pair(name, 20_000, 20_180, mol1, mol2, cig, [("M", 100)])

    # 3. mixed/odd read lengths inside one family + ambiguity bases
    u1, u2 = _rand_seq(rng, 6), _rand_seq(rng, 6)
    for ln in (99, 100, 100, 97):
        s1 = _rand_seq(rng, ln)
        s1 = s1[:10] + "NRYK"[: max(0, min(4, ln - 10))] + s1[14:]
        name = qn("mixlen", bc(u1, u2))
        add_pair(name, 30_000, 30_200, s1, _rand_seq(rng, 100),
                 [("M", ln)], [("M", 100)])

    # 4. missing quals (SAM '*'): qual arrays of size 0
    u1, u2 = _rand_seq(rng, 6), _rand_seq(rng, 6)
    for _ in range(2):
        name = qn("noqual", bc(u1, u2))
        add_pair(name, 40_000, 40_150, _rand_seq(rng, 80), _rand_seq(rng, 80),
                 [("M", 80)], [("M", 80)],
                 q1=np.zeros(0, np.uint8), q2=np.zeros(0, np.uint8))

    # 5. exotic-but-legal tags on every member
    u1, u2 = _rand_seq(rng, 6), _rand_seq(rng, 6)
    tag_soup = {
        "XA": ("A", "c"), "Xc": ("c", -12), "XC": ("C", 250),
        "Xs": ("s", -30000), "XS": ("S", 65000), "Xi": ("i", -(1 << 30)),
        "XI": ("I", (1 << 31) + 7), "Xf": ("f", 1.5), "XZ": ("Z", "free text"),
        "XH": ("H", "DEADBEEF"),
        "XB": ("B", ("i", [-1, 0, 1 << 20])),
        "XD": ("B", ("f", [0.5, -2.25])),
    }
    for _ in range(3):
        name = qn("tags", bc(u1, u2))
        add_pair(name, 50_000, 50_160, _rand_seq(rng, 100), _rand_seq(rng, 100),
                 [("M", 100)], [("M", 100)], tags1=tag_soup, tags2=tag_soup)

    # 6. qname edge cases: near-the-255-limit names, punctuation-rich
    u1, u2 = _rand_seq(rng, 6), _rand_seq(rng, 6)
    long_tail = ":".join(["x" * 9] * 18)  # ~180 chars of qname
    for _ in range(2):
        name = qn("longq", bc(u1, u2), extra=":" + long_tail)
        add_pair(name, 60_000, 60_140, _rand_seq(rng, 100), _rand_seq(rng, 100),
                 [("M", 100)], [("M", 100)])
    name = qn("punct.q-n+m=e", bc(u1, u2))
    add_pair(name, 60_500, 60_640, _rand_seq(rng, 100), _rand_seq(rng, 100),
             [("M", 100)], [("M", 100)])

    # 7. flag soup -> badReads routing: secondary, supplementary, qcfail,
    #    mate-unmapped, and fully-unplaced pairs; duplicate-flagged KEPT
    u1, u2 = _rand_seq(rng, 6), _rand_seq(rng, 6)
    add_pair(qn("dup", bc(u1, u2)), 70_000, 70_150,
             _rand_seq(rng, 100), _rand_seq(rng, 100),
             [("M", 100)], [("M", 100)], flag_extra1=0x400, flag_extra2=0x400)
    add_pair(qn("sec", bc(u1, u2)), 70_000, 70_150,
             _rand_seq(rng, 100), _rand_seq(rng, 100),
             [("M", 100)], [("M", 100)], flag_extra1=0x100, flag_extra2=0x800)
    add_pair(qn("qcf", bc(u1, u2)), 70_000, 70_150,
             _rand_seq(rng, 100), _rand_seq(rng, 100),
             [("M", 100)], [("M", 100)], flag_extra1=0x200, flag_extra2=0x200)
    # placed-unmapped mate: R1 mapped but mate-unmapped bit -> bad
    reads.append(BamRead(
        qname=qn("mu", bc(u1, u2)), flag=0x1 | 0x8 | 0x40, ref=ref_name,
        pos=71_000, mapq=60, cigar=[("M", 60)], mate_ref=ref_name,
        mate_pos=71_000, tlen=0, seq=_rand_seq(rng, 60), qual=qual(60),
    ))
    reads.append(BamRead(  # its unmapped mate, placed at same pos
        qname=qn("mu2", bc(u1, u2)), flag=0x1 | 0x4 | 0x80, ref=ref_name,
        pos=71_000, mapq=0, cigar=[], mate_ref=ref_name, mate_pos=71_000,
        tlen=0, seq=_rand_seq(rng, 60), qual=qual(60),
    ))
    expect["bad_reads"] += 2
    # fully-unplaced pair
    for fl in (0x1 | 0x4 | 0x8 | 0x40, 0x1 | 0x4 | 0x8 | 0x80):
        reads.append(BamRead(
            qname=qn("nc", bc(u1, u2)), flag=fl, ref=None, pos=-1, mapq=0,
            cigar=[], mate_ref=None, mate_pos=-1, tlen=0,
            seq=_rand_seq(rng, 50), qual=qual(50),
        ))
        expect["bad_reads"] += 1
    # barcode-less qname -> bad
    reads.append(BamRead(
        qname="adv:nobc:999", flag=0x1 | 0x2 | 0x40, ref=ref_name, pos=72_000,
        mapq=60, cigar=[("M", 50)], mate_ref=ref_name, mate_pos=72_100,
        tlen=150, seq=_rand_seq(rng, 50), qual=qual(50),
    ))
    expect["bad_reads"] += 1

    # 8. singleton + complementary-strand singleton with indel cigars
    #    (rescue over non-trivial cigars)
    u1, u2 = _rand_seq(rng, 6), _rand_seq(rng, 6)
    mol = _rand_seq(rng, 100)
    add_pair(qn("resA", bc(u1, u2)), 80_000, 80_170, mol, _rand_seq(rng, 100),
             [("S", 3), ("M", 94), ("S", 3)], [("M", 100)])
    add_pair(qn("resB", bc(u2, u1)), 80_000, 80_170, mol, _rand_seq(rng, 100),
             [("S", 3), ("M", 94), ("S", 3)], [("M", 100)], r1_first=False)

    tmp = path + ".unsorted"
    with BamWriter(tmp, header) as w:
        for read in reads:
            w.write(read)
    sort_bam(tmp, path)
    os.unlink(tmp)
    return expect


def simulate_fastq_pairs(out_prefix: str, cfg: SimConfig,
                         chunk_members: int = 500_000,
                         level: int = 4) -> tuple[str, str, str]:
    """Vectorized raw paired-FASTQ generator for the fastq2bam flow
    (SURVEY.md §3.1 at benchmark scale).  The rng draws come in the JAX
    package's order, so one ``SimConfig`` gives the same FASTQ and FASTA
    bytes from both packages.

    Emits ``<prefix>_R1.fastq.gz`` / ``<prefix>_R2.fastq.gz`` (BGZF) plus
    ``<prefix>.ref.fa``: every read is ``UMI + 'T' spacer + genomic
    insert-end`` — the ``--bpattern NNNNNNT``-shaped inline-barcode layout
    extract_barcodes exists to strip — with substitution errors at
    ``cfg.error_rate`` on the genomic part only, so the builtin
    (substitutions-only) aligner can place every read.  Family structure
    (Poisson sizes, duplex dropout, swapped-half barcodes on strand B)
    matches ``simulate_bam_fast``'s statistical model.

    Pure numpy byte assembly: whole chunks of fixed-width FASTQ records are
    built as one (n, rec_len) matrix and BGZF-deflated in batches.
    """
    from consensuscruncher_tpu_torch.io import bgzf

    rng = np.random.default_rng(cfg.seed)
    L, U = cfg.read_len, cfg.umi_len
    Lg = L - U - 1  # genomic bases per read (after UMI + 'T' spacer)
    if Lg < 30:
        raise ValueError("read_len too short for UMI + spacer + useful insert")
    nF = cfg.n_fragments
    if cfg.ref_len < 1000 + 4 * L:
        raise ValueError("ref_len too small for read placement")

    base_lut = np.frombuffer(BASES.encode(), np.uint8)
    ref_codes = rng.integers(0, 4, cfg.ref_len, dtype=np.int8).astype(np.uint8)
    fasta_path = f"{out_prefix}.ref.fa"
    # vectorized FASTA body (write_fasta's per-line loop is slow at scale)
    with open(fasta_path, "wb") as fh:
        fh.write(f">{cfg.ref_name}\n".encode())
        width = 70
        pad = (-len(ref_codes)) % width
        mat = np.full(len(ref_codes) + pad, ord("A"), np.uint8)
        mat[: len(ref_codes)] = base_lut[ref_codes]
        mat = mat.reshape(-1, width)
        out = np.full((mat.shape[0], width + 1), ord("\n"), np.uint8)
        out[:, :width] = mat
        body = out.reshape(-1)
        if pad:
            # drop the padding of the final line, keep its newline
            body = np.concatenate([body[: -(pad + 1)], body[-1:]])
        fh.write(body.tobytes())

    # --- fragment/member tables (vectorized) -----------------------------
    max_insert = 2 * Lg + Lg // 2  # hi = lo + insert must stay on the ref
    if cfg.ref_len < max_insert + 1000:
        raise ValueError("ref_len too small for the insert-size jitter")
    lo = rng.integers(500, cfg.ref_len - max_insert - 500, nF, dtype=np.int64)
    insert = 2 * Lg + rng.integers(0, Lg // 2, nF, dtype=np.int64)
    hi = lo + insert  # exclusive end
    umi_a = rng.integers(0, 4, (nF, U), dtype=np.int8).astype(np.uint8)
    umi_b = rng.integers(0, 4, (nF, U), dtype=np.int8).astype(np.uint8)
    a_size = np.maximum(1, rng.poisson(cfg.mean_family_size, nF)).astype(np.int32)
    duplex = rng.random(nF) < cfg.duplex_fraction
    b_size = np.where(duplex, np.maximum(1, rng.poisson(cfg.mean_family_size, nF)),
                      0).astype(np.int32)
    counts = (a_size + b_size).astype(np.int64)
    M = int(counts.sum())
    frag_of = np.repeat(np.arange(nF, dtype=np.int64), counts)
    starts = np.zeros(nF, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    strand_b = (np.arange(M, dtype=np.int64) - starts[frag_of]) >= a_size[frag_of]

    comp = np.array([3, 2, 1, 0], np.uint8)
    qname_w = 2 + 9 + 1 + 1  # '@f' + 9-digit member serial + ':' + strand
    r1_path, r2_path = f"{out_prefix}_R1.fastq.gz", f"{out_prefix}_R2.fastq.gz"
    w1 = bgzf.BgzfWriter(r1_path, level=level)
    w2 = bgzf.BgzfWriter(r2_path, level=level)
    try:
        for c0 in range(0, M, chunk_members):
            c1 = min(M, c0 + chunk_members)
            n = c1 - c0
            fr = frag_of[c0:c1]
            sb = strand_b[c0:c1]
            # genomic inserts: R1 end = fragment start (fwd), R2 end =
            # fragment end (revcomp); strand B swaps the physical ends.
            fwd = ref_codes[lo[fr, None] + np.arange(Lg, dtype=np.int64)]
            rev = comp[ref_codes[(hi[fr, None] - 1) - np.arange(Lg, dtype=np.int64)]]
            g1 = np.where(sb[:, None], rev, fwd)
            g2 = np.where(sb[:, None], fwd, rev)
            # substitution errors on genomic parts (delta 1..3 mod 4)
            for g in (g1, g2):
                err = rng.random((n, Lg)) < cfg.error_rate
                delta = rng.integers(1, 4, (n, Lg), dtype=np.int8).astype(np.uint8)
                g[err] = (g[err] + delta[err]) & 3
            u1 = np.where(sb[:, None], umi_b[fr], umi_a[fr])
            u2 = np.where(sb[:, None], umi_a[fr], umi_b[fr])

            # fixed-width records: @f<serial>:<A|B>\n SEQ\n +\n QUAL\n
            serial = np.arange(c0, c1, dtype=np.int64)
            qn = np.full((n, qname_w), ord("0"), np.uint8)
            qn[:, 0] = ord("@")
            qn[:, 1] = ord("f")
            digits = serial[:, None] // 10 ** np.arange(8, -1, -1, dtype=np.int64) % 10
            qn[:, 2:11] = (ord("0") + digits).astype(np.uint8)
            qn[:, 11] = ord(":")
            qn[:, 12] = np.where(sb, ord("B"), ord("A")).astype(np.uint8)
            rec_len = qname_w + 1 + L + 1 + 2 + L + 1
            for w, u, g in ((w1, u1, g1), (w2, u2, g2)):
                rec = np.empty((n, rec_len), np.uint8)
                rec[:, :qname_w] = qn
                col = qname_w
                rec[:, col] = ord("\n"); col += 1
                rec[:, col:col + U] = base_lut[u]
                rec[:, col + U] = ord("T")
                rec[:, col + U + 1:col + L] = base_lut[g]
                col += L
                rec[:, col] = ord("\n"); col += 1
                rec[:, col] = ord("+"); col += 1
                rec[:, col] = ord("\n"); col += 1
                rec[:, col:col + L] = 33 + 35  # Q35 flat
                col += L
                rec[:, col] = ord("\n")
                w.write(rec.reshape(-1).tobytes())
    finally:
        w1.close()
        w2.close()
    return r1_path, r2_path, fasta_path
