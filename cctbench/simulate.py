"""The benchmark's input generator: duplex-sequencing reads from a seed.

A frozen rewrite of the program's ``utils/simulate.simulate_bam_fast``
model, kept here so that a change to the program cannot move the
yardstick.  Each fragment ``[lo, hi + L)`` has two strands; strand A reads
R1 forward at ``lo`` and R2 reverse at ``hi`` with barcode ``a.b``, strand
B reads R2 forward at ``lo`` and R1 reverse at ``hi`` with ``b.a``.  Every
strand family holds ``max(min, offset + Poisson(mean))`` read pairs (strand
B only for the duplex fraction of fragments); every read copies its
fragment end's template with substitution errors at ``error_rate`` and
Phred scores uniform in ``[qual_lo, qual_hi]``.  Reads come out in
coordinate order (position, then qname, then flag), as a sorted,
barcode-extracted BAM holds them.

Every seed gets the same work: the fragments' start positions, their
spans and their pairs of family sizes are drawn once from a fixed stream
(``STRUCTURE``), and the seed only deals the spans and the size pairs out
to the positions in another order, and draws the barcodes, the templates,
where the errors fall (always the expected count of them) and the
qualities.  So every seed of a configuration makes the same number of
reads in the same number of families of the same sizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cctbench import bamio

BASES = np.frombuffer(b"ACGT", np.uint8)
STRUCTURE = 20190815  # the fixed stream of positions, spans and family sizes
FLAGS = {  # (strand B, read at hi) -> flag
    (False, False): 0x63, (False, True): 0x93, (True, False): 0xA3, (True, True): 0x53}


@dataclass
class Reads:
    """A generated input, in file order."""

    ref_name: str
    ref_len: int
    umi_len: int
    qnames: np.ndarray    # (n, W) uint8
    flag: np.ndarray      # (n,) int64
    pos: np.ndarray
    mate_pos: np.ndarray
    tlen: np.ndarray
    mapq: np.ndarray
    codes: np.ndarray     # (n, L) uint8, 0-3
    quals: np.ndarray     # (n, L) uint8
    bc_left: np.ndarray   # (n,) int64: the barcode's first half as a base-4 number
    bc_right: np.ndarray

    @property
    def n(self) -> int:
        return len(self.flag)

    def encode(self) -> bytes:
        return bamio.encode_records(self.qnames, self.flag, self.pos, self.mapq,
                                    self.mate_pos, self.tlen, self.codes, self.quals)

    def write(self, path: str, level: int = 6) -> int:
        return bamio.write_bam(path, self.ref_name, self.ref_len, self.encode(), level)


def family_sizes(rng, law: dict, n: int) -> np.ndarray:
    return np.maximum(int(law["min"]),
                      int(law["offset"]) + rng.poisson(float(law["poisson_mean"]), n))


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    out = np.empty((len(values), width), np.uint8)
    v = values.copy()
    for d in range(width - 1, -1, -1):
        out[:, d] = ord("0") + (v % 10)
        v //= 10
    return out


def make_reads(sim: dict, seed) -> Reads:
    """The reads of the configuration's ``simulation`` block from ``seed``
    (an int, or a sequence of ints for a derived stream)."""
    rng = np.random.default_rng(seed)
    fixed = np.random.default_rng(STRUCTURE)
    length, umi = int(sim["read_len"]), int(sim["umi_len"])
    nf, ref_len = int(sim["n_fragments"]), int(sim["ref_len"])
    if ref_len < 1000 + 4 * length:
        raise ValueError("ref_len too small for read placement")
    lo = fixed.integers(1000, ref_len - 3 * length, nf)
    gap = fixed.integers(0, length, nf)
    a_size = family_sizes(fixed, sim["family_size"], nf)
    duplex = fixed.random(nf) < float(sim["duplex_fraction"])
    b_size = np.where(duplex, family_sizes(fixed, sim["family_size"], nf), 0)
    # the seed deals the spans and the pairs of sizes out to the positions
    hi = lo + 2 * length + gap[rng.permutation(nf)]
    deal = rng.permutation(nf)
    a_size, b_size = a_size[deal], b_size[deal]
    umi_a = rng.integers(0, 4, (nf, umi))
    umi_b = rng.integers(0, 4, (nf, umi))
    template = rng.integers(0, 4, (nf, 2, length), dtype=np.uint8)

    # members, fragment-major, strand A then B; two reads each
    counts = a_size + b_size
    members = int(counts.sum())
    frag = np.repeat(np.arange(nf), counts)
    first = np.cumsum(counts) - counts
    strand_b = (np.arange(members) - first[frag]) >= a_size[frag]
    member = np.repeat(np.arange(members), 2)
    at_hi = np.tile(np.array([False, True]), members)
    fr, sb = frag[member], strand_b[member]
    pos = np.where(at_hi, hi[fr], lo[fr])
    # flag order within a member's two reads at one position never matters
    # (they lie at lo and hi); within a position the qname decides
    order = np.lexsort((member, pos))
    member, at_hi, fr, sb, pos = member[order], at_hi[order], fr[order], sb[order], pos[order]
    n = len(order)

    codes = template[fr, at_hi.astype(np.int64)]
    k = int(round(n * length * float(sim["error_rate"])))
    where = rng.integers(0, n * length, k)
    codes.reshape(-1)[where] = rng.integers(0, 4, k, dtype=np.uint8)
    quals = rng.integers(int(sim["qual_lo"]), int(sim["qual_hi"]) + 1, (n, length),
                         dtype=np.uint8)

    flag = np.select([~sb & ~at_hi, ~sb & at_hi, sb & ~at_hi],
                     [FLAGS[(False, False)], FLAGS[(False, True)], FLAGS[(True, False)]],
                     FLAGS[(True, True)]).astype(np.int64)
    mate_pos = np.where(at_hi, lo[fr], hi[fr])
    span = hi[fr] - lo[fr] + length
    tlen = np.where(at_hi, -span, span)
    left = np.where(sb[:, None], umi_b[fr], umi_a[fr])
    right = np.where(sb[:, None], umi_a[fr], umi_b[fr])
    weights = 4 ** np.arange(umi - 1, -1, -1)

    # "sim:FFFFFFFFF:S:MMMMMMMMM|<left>.<right>"
    qn = np.concatenate([
        np.broadcast_to(np.frombuffer(b"sim:", np.uint8), (n, 4)), _digits(fr, 9),
        np.full((n, 1), ord(":"), np.uint8),
        np.where(sb, ord("B"), ord("A")).astype(np.uint8)[:, None],
        np.full((n, 1), ord(":"), np.uint8), _digits(member + 1, 9),
        np.full((n, 1), ord(sim["bdelim"]), np.uint8), BASES[left],
        np.full((n, 1), ord("."), np.uint8), BASES[right]], axis=1)
    return Reads(ref_name=sim["ref_name"], ref_len=ref_len, umi_len=umi,
                 qnames=np.ascontiguousarray(qn), flag=flag, pos=pos, mate_pos=mate_pos,
                 tlen=tlen, mapq=np.full(n, 60, np.int64), codes=codes, quals=quals,
                 bc_left=left @ weights, bc_right=right @ weights)
