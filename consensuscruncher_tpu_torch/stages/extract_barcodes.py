"""Barcode extraction: move inline UMIs from read sequence into the qname.

Port of ``consensuscruncher_tpu/stages/extract_barcodes.py``; host code
only (numpy), as in the JAX package.  Reference parity: ``ConsensusCruncher/extract_barcodes.py`` (SURVEY.md §2).
Supported modes, mirroring the reference surface:

- ``--bpattern`` e.g. ``NNT``: applied to the 5' end of BOTH mates; ``N``
  positions are UMI bases (extracted), any other letter is a spacer position
  (trimmed, not validated — the reference trims without checking).  The whole
  pattern length is removed from seq+qual.
- ``--blist``: whitelist file (one barcode per line).  With a pattern, each
  mate's extracted UMI must be in the list; without a pattern, the UMI length
  is taken from the list entries (which must share one length).
- Reads whose UMI fails the whitelist go to ``<p>_r1_bad.fastq.gz`` /
  ``<p>_r2_bad.fastq.gz`` with original sequence intact.

Output qname (pinned format): ``<original first token><bdelim><UMI1>.<UMI2>``
— both mates get the identical pair so downstream grouping sees one barcode.
Emits ``<p>_r1.fastq.gz`` / ``<p>_r2.fastq.gz``, a barcode-distribution file
``<p>.barcode_distribution.txt`` (barcode<TAB>count) and stats.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

from consensuscruncher_tpu_torch.core.tags import BARCODE_SEP, DEFAULT_BDELIM
from consensuscruncher_tpu_torch.io.fastq import FastqWriter, read_fastq
from consensuscruncher_tpu_torch.utils.stats import StageStats


@dataclass(frozen=True)
class BarcodePattern:
    """Compiled ``--bpattern``: which prefix positions are UMI vs spacer."""

    pattern: str

    def __post_init__(self):
        if not self.pattern or not self.pattern.isalpha():
            raise ValueError(f"invalid barcode pattern {self.pattern!r}")
        if "N" not in self.pattern.upper():
            raise ValueError(
                f"barcode pattern {self.pattern!r} has no N (UMI) positions — "
                "every read would get an empty UMI and families would collapse "
                "by position alone"
            )

    @property
    def length(self) -> int:
        return len(self.pattern)

    @property
    def umi_positions(self) -> tuple[int, ...]:
        return tuple(i for i, c in enumerate(self.pattern) if c.upper() == "N")

    def extract(self, seq: str) -> str:
        return "".join(seq[i] for i in self.umi_positions)


def load_blist(path) -> set[str]:
    barcodes = set()
    with open(path) as fh:
        for line in fh:
            bc = line.strip().upper()
            if bc:
                barcodes.add(bc)
    if not barcodes:
        raise ValueError(f"empty barcode list: {path}")
    lengths = {len(b) for b in barcodes}
    if len(lengths) != 1:
        raise ValueError(f"barcode list {path} mixes lengths {sorted(lengths)}")
    return barcodes


@dataclass
class ExtractResult:
    r1_out: str
    r2_out: str
    stats: StageStats


def output_paths(out_prefix: str) -> dict[str, str]:
    """Every file :func:`run_extract` writes for ``out_prefix`` — the single
    naming authority shared with the CLI's resume manifest (all are
    deterministic for a given input; stats carry no timestamps)."""
    return {
        "r1": f"{out_prefix}_r1.fastq.gz",
        "r2": f"{out_prefix}_r2.fastq.gz",
        "r1_bad": f"{out_prefix}_r1_bad.fastq.gz",
        "r2_bad": f"{out_prefix}_r2_bad.fastq.gz",
        "distribution": f"{out_prefix}.barcode_distribution.txt",
        "stats": f"{out_prefix}.extract_stats.txt",
        "stats_json": f"{out_prefix}.extract_stats.json",
    }


def _batch_zipper(read1: str, read2: str):
    """Yield aligned column slices from both FASTQs; raises on unequal
    record counts (the object path's ``zip(strict=True)`` contract)."""
    from consensuscruncher_tpu_torch.io.fastq import read_fastq_batches

    def cols(b, lo, hi):
        return (b.data, b.name_start[lo:hi], b.name_len[lo:hi],
                b.seq_start[lo:hi], b.seq_len[lo:hi], b.qual_start[lo:hi])

    it1, it2 = read_fastq_batches(read1), read_fastq_batches(read2)
    b1 = b2 = None
    o1 = o2 = 0
    while True:
        if b1 is None or o1 >= b1.n:
            b1, o1 = next(it1, None), 0
        if b2 is None or o2 >= b2.n:
            b2, o2 = next(it2, None), 0
        if b1 is None or b2 is None:
            break
        k = min(b1.n - o1, b2.n - o2)
        yield cols(b1, o1, o1 + k), cols(b2, o2, o2 + k)
        o1 += k
        o2 += k
    leftover1 = (b1 is not None and o1 < b1.n) or next(it1, None) is not None
    leftover2 = (b2 is not None and o2 < b2.n) or next(it2, None) is not None
    if leftover1 or leftover2:
        raise ValueError("R1/R2 FASTQ record counts differ")


_UPPER = None


def _upper_lut():
    global _UPPER
    if _UPPER is None:
        import numpy as np

        lut = np.arange(256, dtype=np.uint8)
        lut[ord("a"):ord("z") + 1] -= 32
        _UPPER = lut
    return _UPPER


def tok_matrix(data, starts, lens):
    """(matrix, tok_len): name bytes up to the first whitespace (space or
    tab — the object paths' str.split() contract).  Shared by the extract
    stage and the columnar aligner (stages/align.py)."""
    import numpy as np

    from consensuscruncher_tpu_torch.utils.ragged import scatter_runs

    w = int(lens.max()) if len(lens) else 0
    mat = np.zeros((len(starts), max(w, 1)), np.uint8)
    if w:
        scatter_runs(mat.reshape(-1),
                     np.arange(len(starts), dtype=np.int64) * mat.shape[1],
                     data, lens.astype(np.int64),
                     src_starts=starts.astype(np.int64))
    ws = (mat == 32) | (mat == 9)
    has = ws.any(axis=1)
    tok_len = np.where(has, np.argmax(ws, axis=1), lens)
    # zero out beyond the token so row equality == token equality
    mat[np.arange(mat.shape[1])[None, :] >= tok_len[:, None]] = 0
    return mat, tok_len


def _run_extract_vectorized(
    read1, read2, pattern, whitelist, bdelim, stats, distribution, writers
) -> None:
    """Columnar extract: one pass of array ops per aligned batch pair.
    Byte-parity with the object loop is pinned by tests/test_torch_extract.py."""
    import numpy as np

    from consensuscruncher_tpu_torch.core.qnames import build_strings, const, fixed, ragged

    P = pattern.length
    upos = np.asarray(pattern.umi_positions, dtype=np.int64)
    U = len(upos)
    upper = _upper_lut()
    wl_arr = None
    if whitelist is not None:
        wl_arr = np.array(sorted(w.encode("ascii") for w in whitelist),
                          dtype=f"S{U}")
    sep_b = np.frombuffer(BARCODE_SEP.encode(), np.uint8)

    for c1, c2 in _batch_zipper(read1, read2):
        d1, ns1, nl1, ss1, sl1, qs1 = c1
        d2, ns2, nl2, ss2, sl2, qs2 = c2
        k = len(ns1)
        stats.incr("read_pairs", k)
        t1, tl1 = tok_matrix(d1, ns1, nl1)
        t2, tl2 = tok_matrix(d2, ns2, nl2)
        wmin = min(t1.shape[1], t2.shape[1])
        agree = (tl1 == tl2) & (t1[:, :wmin] == t2[:, :wmin]).all(axis=1)
        if t1.shape[1] > wmin:
            agree &= (t1[:, wmin:] == 0).all(axis=1)
        if t2.shape[1] > wmin:
            agree &= (t2[:, wmin:] == 0).all(axis=1)
        if not agree.all():
            i = int(np.argmin(agree))
            a = bytes(t1[i, : tl1[i]]).decode("ascii", "replace")
            b = bytes(t2[i, : tl2[i]]).decode("ascii", "replace")
            raise ValueError(f"R1/R2 qname mismatch: {a!r} vs {b!r}")

        too_short = (sl1 < P) | (sl2 < P)
        u1 = upper[d1[np.minimum(ss1[:, None] + upos[None, :], len(d1) - 1)]]
        u2 = upper[d2[np.minimum(ss2[:, None] + upos[None, :], len(d2) - 1)]]
        if wl_arr is not None:
            in1 = np.isin(np.ascontiguousarray(u1).view(f"S{U}").ravel(), wl_arr)
            in2 = np.isin(np.ascontiguousarray(u2).view(f"S{U}").ravel(), wl_arr)
            bad_bc = ~too_short & ~(in1 & in2)
        else:
            bad_bc = np.zeros(k, bool)
        good = ~too_short & ~bad_bc
        # guard zero increments: the object loop only creates counter keys
        # it touches, and stats files are parity artifacts
        for key, val in (("too_short", int(too_short.sum())),
                         ("bad_barcode", int(bad_bc.sum())),
                         ("extracted", int(good.sum()))):
            if val:
                stats.incr(key, val)

        bad = ~good
        if bad.any():
            for (d, ns, nl, ss, sl, qs, wkey) in (
                (d1, ns1, nl1, ss1, sl1, qs1, "r1_bad"),
                (d2, ns2, nl2, ss2, sl2, qs2, "r2_bad"),
            ):
                data, off = build_strings(int(bad.sum()), [
                    const(b"@"),
                    ragged(d, nl[bad], starts=ns[bad]),
                    const(b"\n"),
                    ragged(d, sl[bad], starts=ss[bad]),
                    const(b"\n+\n"),
                    ragged(d, sl[bad], starts=qs[bad]),
                    const(b"\n"),
                ])
                writers[wkey].write_bytes(data.tobytes())
        if good.any():
            g = np.nonzero(good)[0]
            bc = np.empty((len(g), 2 * U + len(sep_b)), np.uint8)
            bc[:, :U] = u1[g]
            bc[:, U:U + len(sep_b)] = sep_b
            bc[:, U + len(sep_b):] = u2[g]
            # distribution (vectorized unique over the barcode matrix)
            uq, counts = np.unique(
                np.ascontiguousarray(bc).view(f"S{bc.shape[1]}").ravel(),
                return_counts=True,
            )
            for ub, cnt in zip(uq, counts):
                distribution[ub.decode("ascii")] += int(cnt)
            for (d, ss, sl, qs, tok, tok_l, wkey) in (
                (d1, ss1, sl1, qs1, t1, tl1, "r1"),
                (d2, ss2, sl2, qs2, t2, tl2, "r2"),
            ):
                data, off = build_strings(len(g), [
                    const(b"@"),
                    ragged(tok.reshape(-1), tok_l[g],
                           starts=g.astype(np.int64) * tok.shape[1]),
                    const(bdelim.encode("ascii")),
                    fixed(bc),
                    const(b"\n"),
                    ragged(d, sl[g] - P, starts=ss[g] + P),
                    const(b"\n+\n"),
                    ragged(d, sl[g] - P, starts=qs[g] + P),
                    const(b"\n"),
                ])
                writers[wkey].write_bytes(data.tobytes())


def run_extract(
    read1: str,
    read2: str,
    out_prefix: str,
    bpattern: str | None = None,
    blist: str | None = None,
    bdelim: str = DEFAULT_BDELIM,
    level: int = 6,
    bad_level: int | None = None,
    _force_object: bool = False,
) -> ExtractResult:
    if bpattern is None and blist is None:
        raise ValueError("need --bpattern and/or --blist to locate UMIs")
    whitelist = load_blist(blist) if blist else None
    if bpattern is None:
        umi_len = len(next(iter(whitelist)))
        pattern = BarcodePattern("N" * umi_len)
    else:
        pattern = BarcodePattern(bpattern)
        if whitelist is not None:
            wl_len = len(next(iter(whitelist)))
            if wl_len != len(pattern.umi_positions):
                raise ValueError(
                    f"--bpattern extracts {len(pattern.umi_positions)}-base UMIs but "
                    f"--blist contains {wl_len}-base barcodes — every read would be rejected"
                )

    stats = StageStats("extract_barcodes")
    distribution: Counter = Counter()
    all_paths = output_paths(out_prefix)
    paths = {k: all_paths[k] for k in ("r1", "r2", "r1_bad", "r2_bad")}
    # The bad-read FASTQs are kept outputs even when the tag FASTQs are
    # downshifted as soon-deleted intermediates — separate level knob.
    bl = level if bad_level is None else bad_level
    writers = {k: FastqWriter(p, level=bl if k.endswith("_bad") else level)
               for k, p in paths.items()}
    if not _force_object:
        try:
            _run_extract_vectorized(
                read1, read2, pattern, whitelist, bdelim, stats, distribution, writers
            )
        finally:
            for w in writers.values():
                w.close()
        with open(f"{out_prefix}.barcode_distribution.txt", "w") as fh:
            fh.write("barcode\tcount\n")
            for bc, count in sorted(distribution.items()):
                fh.write(f"{bc}\t{count}\n")
        stats.set("unique_barcodes", len(distribution))
        stats.write(f"{out_prefix}.extract_stats.txt")
        return ExtractResult(paths["r1"], paths["r2"], stats)
    try:
        for (n1, s1, q1), (n2, s2, q2) in zip(
            read_fastq(read1), read_fastq(read2), strict=True
        ):
            stats.incr("read_pairs")
            tok1, tok2 = n1.split()[0], n2.split()[0]
            if tok1 != tok2:
                raise ValueError(f"R1/R2 qname mismatch: {tok1!r} vs {tok2!r}")
            if len(s1) < pattern.length or len(s2) < pattern.length:
                stats.incr("too_short")
                writers["r1_bad"].write(n1, s1, q1)
                writers["r2_bad"].write(n2, s2, q2)
                continue
            umi1 = pattern.extract(s1).upper()
            umi2 = pattern.extract(s2).upper()
            if whitelist is not None and (umi1 not in whitelist or umi2 not in whitelist):
                stats.incr("bad_barcode")
                writers["r1_bad"].write(n1, s1, q1)
                writers["r2_bad"].write(n2, s2, q2)
                continue
            barcode = f"{umi1}{BARCODE_SEP}{umi2}"
            distribution[barcode] += 1
            stats.incr("extracted")
            qname = f"{tok1}{bdelim}{barcode}"
            writers["r1"].write(qname, s1[pattern.length :], q1[pattern.length :])
            writers["r2"].write(qname, s2[pattern.length :], q2[pattern.length :])
    finally:
        for w in writers.values():
            w.close()

    with open(f"{out_prefix}.barcode_distribution.txt", "w") as fh:
        fh.write("barcode\tcount\n")
        for bc, count in sorted(distribution.items()):
            fh.write(f"{bc}\t{count}\n")
    stats.set("unique_barcodes", len(distribution))
    stats.write(f"{out_prefix}.extract_stats.txt")
    return ExtractResult(paths["r1"], paths["r2"], stats)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Extract UMIs from FASTQ into read names")
    p.add_argument("--read1", required=True)
    p.add_argument("--read2", required=True)
    p.add_argument("--outfile", required=True, help="output prefix")
    p.add_argument("--bpattern", default=None, help="e.g. NNT (N=UMI base, else spacer)")
    p.add_argument("--blist", default=None, help="barcode whitelist file")
    p.add_argument("--bdelim", default=DEFAULT_BDELIM)
    args = p.parse_args(argv)
    run_extract(args.read1, args.read2, args.outfile, args.bpattern, args.blist, args.bdelim)


if __name__ == "__main__":
    main()
