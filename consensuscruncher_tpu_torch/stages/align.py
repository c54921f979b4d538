"""Built-in paired-end aligner: ``fastq2bam --bwa builtin``.

Port of ``consensuscruncher_tpu/stages/align.py``.  The JAX package runs
this aligner on the host with numpy, and so does the port: it has no
device work and imports no torch.  The reference delegates alignment to an external ``bwa mem`` subprocess
(``ConsensusCruncher.py`` fastq2bam, SURVEY.md §3.1) and so does this
framework by default.  This module exists for the environments the
reference cannot handle at all — no aligner installed — so the FULL
fastq2bam flow still runs: k-mer seeding against an in-memory reference
index + ungapped extension with mismatch counting, emitting the same
coordinate-sorted barcoded BAM the external path produces.

Scope is deliberate: exact-stride seeds and ungapped extension handle
substitution-style sequencing error (the consensus pipeline's whole
subject) but NOT indels/clipping/splicing — it is a test/demo aligner
with honest limits, not a bwa replacement.  CIGAR is always full-length
``M``; unalignable reads come out unmapped (flag 0x4) and flow to the
pipeline's badReads path.

Reads are held as uint8 code matrices and seed votes are numpy passes.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np

from consensuscruncher_tpu_torch.io.fasta import read_fasta
from consensuscruncher_tpu_torch.utils.faults import FaultError, fault_point

_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[ord(chr(_c).lower())] = _i
_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
# code-space complement: A0<->T3, C1<->G2; N(4) and invalid bytes unchanged
_REVCOMP_LUT = np.arange(256, dtype=np.uint8)
_REVCOMP_LUT[:4] = [3, 2, 1, 0]


def revcomp(seq: str) -> str:
    return "".join(_COMP.get(c, "N") for c in reversed(seq))


def _encode(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode(), np.uint8)]


@dataclass(frozen=True)
class Hit:
    ref: str
    pos: int  # 0-based leftmost
    reverse: bool
    nm: int  # mismatches
    mapq: int


class _SortedKmerIndex:
    """Vectorized reference k-mer index: one sorted int64 key array + the
    matching global positions, built with array passes only (the former
    ``dict[kmer] -> list`` form cost one Python dict insert per reference
    base, which at chromosome scale is minutes and gigabytes).

    Refs concatenate into ``gcodes`` with a single 0xFF separator byte
    between them — any k-window crossing a boundary contains the separator
    and is dropped by the validity mask, so no k-mer spans two refs.
    Equal keys keep position-ascending order (stable argsort), preserving
    the scan order the old dict-of-lists produced.
    """

    def __init__(self, ref_codes: list[np.ndarray], k: int):
        self.k = k
        lens = np.array([len(c) for c in ref_codes], np.int64)
        self.lens = lens
        bases, parts, off = [], [], 0
        for i, c in enumerate(ref_codes):
            bases.append(off)
            parts.append(c)
            off += len(c)
            if i < len(ref_codes) - 1:
                parts.append(np.full(1, 0xFF, np.uint8))
                off += 1
        self.gbase = np.asarray(bases, np.int64)
        self.gcodes = (np.concatenate(parts) if parts
                       else np.zeros(0, np.uint8))
        g = len(self.gcodes)
        if g >= k:
            valid = self.gcodes < 4
            nk = g - k + 1
            keys = np.zeros(nk, np.int64)
            ok = np.ones(nk, bool)
            for j in range(k):
                keys = (keys << 2) | self.gcodes[j:j + nk].astype(np.int64)
                ok &= valid[j:j + nk]
            pos = np.nonzero(ok)[0]
            keys = keys[pos] & ((np.int64(1) << (2 * k)) - 1)
            order = np.argsort(keys, kind="stable")
            self.skmers = keys[order]
            self.spos = pos[order]
        else:
            self.skmers = np.zeros(0, np.int64)
            self.spos = np.zeros(0, np.int64)
        # Prefix radix table: the first PREF_BITS levels of every binary
        # search collapse to one table lookup, and the remaining search
        # runs inside a ~|index|/2^pref_bits-entry window (cache-resident).
        # Plain np.searchsorted over a chromosome-scale index is a random
        # 25-probe cold-cache walk per seed.
        self.pref_bits = min(2 * k, max(10, int(np.log2(max(len(self.skmers), 2))) - 6))
        self._pref_shift = 2 * k - self.pref_bits
        pref = self.skmers >> self._pref_shift
        self.pref_table = np.searchsorted(
            pref, np.arange((np.int64(1) << self.pref_bits) + 1, dtype=np.int64))

    def lookup_batch(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized equal-range over the sorted index: ``(lo, hi)`` per
        key, via the prefix table + a windowed binary search — native C++
        per-key (registers over a cache-resident window) when the codec
        library is available, else the numpy branchless lockstep loop."""
        pref = keys >> self._pref_shift
        lo_l = self.pref_table[pref]
        hi_l = self.pref_table[pref + 1]
        try:
            from consensuscruncher_tpu_torch.io import native

            return native.equal_range_windowed(self.skmers, keys, lo_l, hi_l)
        except RuntimeError:
            pass
        lo_r, hi_r = lo_l.copy(), hi_l.copy()
        width = int((hi_l - lo_l).max(initial=0))
        steps = max(1, int(np.ceil(np.log2(width + 1)))) if width else 0
        guard = max(len(self.skmers) - 1, 0)
        for _ in range(steps):
            # Converged lanes (lo == hi) must FREEZE: the fixed-step loop
            # keeps running for the widest bucket, and a clamped re-read at
            # lo == hi == len(skmers) compares "go right" and would walk
            # the bound past the array (the top-key k-mers).
            # left bound: first index with skmers[i] >= key
            act = lo_l < hi_l
            mid = (lo_l + hi_l) >> 1
            v = self.skmers[np.minimum(mid, guard)]
            right = act & (v < keys)
            lo_l = np.where(right, mid + 1, lo_l)
            hi_l = np.where(act & ~right, mid, hi_l)
            # right bound: first index with skmers[i] > key
            act = lo_r < hi_r
            mid = (lo_r + hi_r) >> 1
            v = self.skmers[np.minimum(mid, guard)]
            right = act & (v <= keys)
            lo_r = np.where(right, mid + 1, lo_r)
            hi_r = np.where(act & ~right, mid, hi_r)
        return lo_l, lo_r

    def lookup(self, key: int) -> np.ndarray:
        """Global positions of one k-mer (position-ascending)."""
        lo = int(np.searchsorted(self.skmers, key))
        hi = int(np.searchsorted(self.skmers, key, side="right"))
        return self.spos[lo:hi]

    def ref_of(self, gpos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized global position -> (ref_idx, local_pos)."""
        ri = np.searchsorted(self.gbase, gpos, side="right") - 1
        return ri, gpos - self.gbase[ri]


class BuiltinAligner:
    """K-mer seed + ungapped extend against an in-memory reference."""

    def __init__(self, fasta_path, k: int = 21, seed_stride: int = 7,
                 max_mismatch_frac: float = 0.1):
        self.k = k
        self.seed_stride = seed_stride
        self.max_mismatch_frac = max_mismatch_frac
        self.refs: list[tuple[str, int]] = []
        self._ref_codes: dict[str, np.ndarray] = {}
        codes_list: list[np.ndarray] = []
        for name, seq in read_fasta(fasta_path).items():
            codes = _encode(seq)
            self.refs.append((name, len(seq)))
            self._ref_codes[name] = codes
            codes_list.append(codes)
        self._sidx = _SortedKmerIndex(codes_list, k)

    def _seed_votes(self, codes: np.ndarray):
        """Candidate (ref, diagonal) offsets from strided seed lookups."""
        k = self.k
        votes: dict[tuple[str, int], int] = {}
        if len(codes) < k:
            return votes
        for start in range(0, len(codes) - k + 1, self.seed_stride):
            window = codes[start : start + k]
            if (window >= 4).any():
                continue
            key = 0
            for v in window:
                key = (key << 2) | int(v)
            hits = self._sidx.lookup(key)
            if len(hits):
                ris, lps = self._sidx.ref_of(hits)
                for ri, lp in zip(ris, lps):
                    diag = int(lp) - start
                    rk = (self.refs[int(ri)][0], diag)
                    votes[rk] = votes.get(rk, 0) + 1
        return votes

    def _extend(self, codes: np.ndarray, ref: str, pos: int) -> int | None:
        """Ungapped mismatch count at (ref, pos), or None if out of bounds."""
        rc = self._ref_codes[ref]
        if pos < 0 or pos + len(codes) > len(rc):
            return None
        window = rc[pos : pos + len(codes)]
        return int((window != codes).sum())

    def align(self, seq: str) -> Hit | None:
        """Best ungapped placement of ``seq`` on either strand."""
        max_nm = int(len(seq) * self.max_mismatch_frac)
        candidates: list[tuple[int, str, int, bool]] = []
        for reverse in (False, True):
            s = revcomp(seq) if reverse else seq
            codes = _encode(s)
            votes = self._seed_votes(codes)
            # Try diagonals by vote count; a few candidates suffice for
            # substitution-only error.
            for (ref, diag), _n in sorted(votes.items(), key=lambda kv: -kv[1])[:4]:
                nm = self._extend(codes, ref, diag)
                if nm is not None and nm <= max_nm:
                    candidates.append((nm, ref, diag, reverse))
        if not candidates:
            return None
        candidates.sort(key=lambda c: c[0])
        nm, ref, pos, reverse = candidates[0]
        # bwa-flavoured mapq: confident when the runner-up is clearly worse.
        mapq = 60 if len(candidates) == 1 else \
            max(0, min(60, 10 * (candidates[1][0] - nm)))
        return Hit(ref=ref, pos=pos, reverse=reverse, nm=nm, mapq=mapq)

    # -------------------------------------------------------------- batch
    _HIT_CAP = 64   # hits taken per seed (repetitive k-mers truncate here)
    _TOP_C = 4      # diagonals extended per strand (matches align())

    def align_batch(self, codes: np.ndarray) -> dict:
        """Vectorized :meth:`align` over a ``(B, L)`` uint8 code batch.

        One numpy pass replaces B per-read Python walks.  Semantics
        match :meth:`align` (same seeds, same top-``_TOP_C``-by-votes
        candidate rule with first-seen tie order, same stable min-nm pick,
        same mapq) except that pathological repetitive seeds truncate at
        ``_HIT_CAP`` hits.  Returns ``(B,)`` arrays: ``mapped`` (bool),
        ``ref_idx``/``pos``/``nm``/``mapq`` (int32, -1/0 where unmapped),
        ``reverse`` (bool).
        """
        B, L = codes.shape
        k, stride = self.k, self.seed_stride
        out = {
            "mapped": np.zeros(B, bool),
            "ref_idx": np.full(B, -1, np.int32),
            "pos": np.full(B, -1, np.int64),
            "nm": np.zeros(B, np.int32),
            "mapq": np.zeros(B, np.int32),
            "reverse": np.zeros(B, bool),
        }
        if B == 0 or L < k or not len(self._sidx.skmers):
            return out
        max_nm = int(L * self.max_mismatch_frac)

        # Both strands as one (2B, L) block: row 2r = forward, 2r+1 = rev.
        rc = _REVCOMP_LUT[codes[:, ::-1]]
        allc = np.empty((2 * B, L), np.uint8)
        allc[0::2] = codes
        allc[1::2] = rc

        # --- strided seed keys ------------------------------------------
        starts = np.arange(0, L - k + 1, stride, dtype=np.int64)
        S = len(starts)
        keys = np.zeros((2 * B, S), np.int64)
        ok = np.ones((2 * B, S), bool)
        for j in range(k):
            col = allc[:, starts + j]
            keys = (keys << 2) | col.astype(np.int64)
            ok &= col < 4
        keys &= (np.int64(1) << (2 * k)) - 1

        # --- index lookups ----------------------------------------------
        flat_keys = keys.reshape(-1)
        flat_ok = ok.reshape(-1)
        lo, hi = self._sidx.lookup_batch(flat_keys)
        cnt = np.where(flat_ok, np.minimum(hi - lo, self._HIT_CAP), 0)
        H = int(cnt.sum())
        if H == 0:
            return out
        seed_of = np.repeat(np.arange(2 * B * S, dtype=np.int64), cnt)
        within = np.arange(H, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
        gpos = self._sidx.spos[lo[seed_of] + within]
        row = seed_of // S
        sstart = starts[seed_of % S]
        diag = gpos - sstart                      # global candidate start
        # Vote key must carry the hit's REF, not just the global diagonal:
        # hits on two adjacent refs can share a diag value and align()
        # keeps their votes separate (per (ref, local_diag)).
        hit_ref = np.searchsorted(self._sidx.gbase, gpos, side="right") - 1
        vkey = (hit_ref << 44) | (diag + (np.int64(1) << 20))
        seen = np.arange(H, dtype=np.int64)       # first-seen order = scan order

        # --- vote per (row, ref, diag): run-length over the sorted pairs --
        o = np.lexsort((seen, vkey, row))
        row_s, vkey_s, seen_s = row[o], vkey[o], seen[o]
        new = np.empty(H, bool)
        new[0] = True
        new[1:] = (row_s[1:] != row_s[:-1]) | (vkey_s[1:] != vkey_s[:-1])
        run_start = np.nonzero(new)[0]
        votes = np.diff(np.concatenate([run_start, [H]]))
        c_row = row_s[run_start]
        c_diag = diag[o][run_start]
        c_seen = seen_s[run_start]  # min within run (seen sorted last key)

        # --- top _TOP_C per row by (votes desc, first-seen asc) ----------
        o2 = np.lexsort((c_seen, -votes, c_row))
        rr = c_row[o2]
        first = np.empty(len(rr), bool)
        first[0] = True
        first[1:] = rr[1:] != rr[:-1]
        rank = np.arange(len(rr)) - np.maximum.accumulate(
            np.where(first, np.arange(len(rr)), 0))
        keep = rank < self._TOP_C
        k_row = rr[keep]
        k_diag = c_diag[o2][keep]
        k_rank = rank[keep]

        # --- bounds + ungapped extension --------------------------------
        ri, lp = self._sidx.ref_of(k_diag)
        inb = (k_diag >= 0) & (lp >= 0) & (lp + L <= self._sidx.lens[ri])
        k_row, k_diag, k_rank, ri, lp = (a[inb] for a in
                                         (k_row, k_diag, k_rank, ri, lp))
        if not len(k_row):
            return out
        win = self._sidx.gcodes[k_diag[:, None] + np.arange(L, dtype=np.int64)]
        nm = (win != allc[k_row]).sum(1).astype(np.int64)
        good = nm <= max_nm
        k_row, k_diag, k_rank, ri, lp, nm = (a[good] for a in
                                             (k_row, k_diag, k_rank, ri, lp, nm))
        if not len(k_row):
            return out

        # --- stable min-nm per READ across both strands ------------------
        # candidate insertion order in align(): forward strand's top-4
        # first, then reverse's — i.e. (strand, vote-rank); pick by
        # (nm, order) like the stable sort in align().
        read = k_row >> 1
        order = (k_row & 1) * self._TOP_C + k_rank
        o3 = np.lexsort((order, nm, read))
        rd = read[o3]
        first = np.empty(len(rd), bool)
        first[0] = True
        first[1:] = rd[1:] != rd[:-1]
        best = np.nonzero(first)[0]
        n_cand = np.diff(np.concatenate([best, [len(rd)]]))
        b_read = rd[best]
        b_nm = nm[o3][best]
        runner_nm = np.where(n_cand > 1,
                             nm[o3][np.minimum(best + 1, len(rd) - 1)], 0)
        mapq = np.where(
            n_cand == 1, 60,
            np.clip(10 * (runner_nm - b_nm), 0, 60)).astype(np.int32)
        out["mapped"][b_read] = True
        out["ref_idx"][b_read] = ri[o3][best].astype(np.int32)
        out["pos"][b_read] = lp[o3][best]
        out["nm"][b_read] = b_nm.astype(np.int32)
        out["mapq"][b_read] = mapq
        out["reverse"][b_read] = (k_row[o3][best] & 1).astype(bool)
        return out


def _align_tasks(r1: str, r2: str, pair_chunk: int):
    """Yield compact per-chunk task tuples ``(seq1, qual1, seq2, qual2,
    tok, tok_lens)`` — equal-length byte matrices gathered out of the
    FASTQ batch buffers, so a task pickles as a few small arrays instead
    of dragging the whole batch through the pool pipe."""
    from consensuscruncher_tpu_torch.stages.extract_barcodes import (_batch_zipper,
                                                               tok_matrix)

    for c1, c2 in _batch_zipper(r1, r2):
        d1, ns1, nl1, ss1, sl1, qs1 = c1
        d2, ns2, nl2, ss2, sl2, qs2 = c2
        tok1, tl1 = tok_matrix(d1, ns1, nl1)
        tok2, tl2 = tok_matrix(d2, ns2, nl2)
        w = max(tok1.shape[1], tok2.shape[1])
        p1 = np.zeros((len(tl1), w), np.uint8)
        p2 = np.zeros((len(tl2), w), np.uint8)
        p1[:, :tok1.shape[1]] = tok1
        p2[:, :tok2.shape[1]] = tok2
        bad = (tl1 != tl2) | (p1 != p2).any(1)
        if bad.any():
            i = int(np.nonzero(bad)[0][0])
            t1 = bytes(tok1[i, : tl1[i]]).decode(errors="replace")
            t2 = bytes(tok2[i, : tl2[i]]).decode(errors="replace")
            raise SystemExit(f"R1/R2 qname mismatch: {t1!r} vs {t2!r}")
        # equal-length buckets (usually exactly one for real runs)
        lkey = sl1.astype(np.int64) << 32 | sl2.astype(np.int64)
        for key in np.unique(lkey):
            sel = np.nonzero(lkey == key)[0]
            l1, l2 = int(key >> 32), int(key & 0xFFFFFFFF)
            a1 = np.arange(l1, dtype=np.int64)
            a2 = np.arange(l2, dtype=np.int64)
            for c0 in range(0, len(sel), pair_chunk):
                sc = sel[c0:c0 + pair_chunk]
                yield (d1[ss1[sc, None] + a1], d1[qs1[sc, None] + a1],
                       d2[ss2[sc, None] + a2], d2[qs2[sc, None] + a2],
                       np.ascontiguousarray(tok1[sc]), tl1[sc])


# Fork-pool worker state: set in the parent immediately before the pool
# forks, inherited copy-on-write by the children (the k-mer index is
# hundreds of MB at genome scale — pickling it per task is a non-starter).
_POOL_ALIGNER: "BuiltinAligner | None" = None
_POOL_EMIT_LUT: np.ndarray | None = None
_POOL_PRESTART_BARRIER = None


def _barrier_timeout_s() -> float:
    """Prestart-barrier wait budget.  120s absorbs a badly overloaded
    host's fork storm; chaos tests shrink it via the environment (which
    crosses the fork boundary) to exercise the REAL timeout path rather
    than a parent-side injected stand-in."""
    try:
        return float(os.environ.get("CCT_ALIGN_BARRIER_TIMEOUT_S", "120"))
    except ValueError:
        return 120.0


def _pool_prestart_wait():
    """Pin one pool worker until every worker has forked (see the prestart
    barrier in :func:`align_fastqs_columnar`)."""
    # chaos site in the CHILD: a stalled/dead worker here is what makes
    # the parent's barrier wait time out for real
    fault_point("align.barrier_worker")
    _POOL_PRESTART_BARRIER.wait(timeout=_barrier_timeout_s())


def _pool_bucket_blobs(task):
    from consensuscruncher_tpu_torch.io.encode import encode_records

    fault_point("align.pool_worker")  # chaos site: injected worker death
    return _bucket_blobs(_POOL_ALIGNER, encode_records, _POOL_EMIT_LUT, *task)


def _shutdown_pool(pool, kill: bool) -> None:
    """``kill=True``: abort path — SIGTERM the forked workers so in-flight
    chunks stop NOW (executor shutdown only cancels queued futures; running
    chunks would otherwise burn CPU + the COW index until they drain).
    ``kill=False``: drained path — clean join."""
    if kill:
        pool.shutdown(wait=False, cancel_futures=True)
        # _processes is None once the executor is broken/shut down
        for p in list((getattr(pool, "_processes", None) or {}).values()):
            try:
                p.terminate()
            except Exception:
                pass
    else:
        pool.shutdown(wait=True)


def _start_pool(workers: int, aligner, emit_lut):
    """Fork + warm an align pool behind the prestart barrier.

    Returns the executor, or None when warm-up fails (barrier timeout on an
    overloaded host, injected fault) — the caller degrades to serial
    alignment with a warning instead of aborting a multi-hour run.  Output
    bytes are identical either way (the writer's order is content-keyed),
    so degradation costs wall-clock only.
    """
    import concurrent.futures as cf
    import multiprocessing as mp
    import threading

    global _POOL_ALIGNER, _POOL_EMIT_LUT, _POOL_PRESTART_BARRIER
    ctx = mp.get_context("fork")
    _POOL_ALIGNER, _POOL_EMIT_LUT = aligner, emit_lut
    _POOL_PRESTART_BARRIER = ctx.Barrier(workers + 1)
    pool = cf.ProcessPoolExecutor(workers, mp_context=ctx)
    try:
        # Force every worker to fork NOW: each barrier task pins the
        # worker that picks it up, so the executor's on-demand spawner
        # must create all `workers` processes before the parent (the
        # +1-th party) releases them — i.e. before the sorting writer
        # and its async BGZF thread exist.
        warm = [pool.submit(_pool_prestart_wait) for _ in range(workers)]
        fault_point("align.barrier")
        timeout = _barrier_timeout_s()
        _POOL_PRESTART_BARRIER.wait(timeout=timeout)
        for f in warm:
            f.result(timeout=timeout)
    except (threading.BrokenBarrierError, cf.TimeoutError, FaultError) as e:
        _shutdown_pool(pool, kill=True)
        _POOL_ALIGNER = _POOL_EMIT_LUT = _POOL_PRESTART_BARRIER = None
        print(f"WARNING: align pool warm-up failed ({e!r}); "
              "falling back to serial alignment", file=sys.stderr, flush=True)
        return None
    except BaseException:
        # anything else (KeyboardInterrupt, executor bug) must not leak the
        # executor or pin the COW index
        _shutdown_pool(pool, kill=True)
        _POOL_ALIGNER = _POOL_EMIT_LUT = _POOL_PRESTART_BARRIER = None
        raise
    return pool


def align_fastqs_columnar(aligner: BuiltinAligner, r1: str, r2: str,
                          out_bam: str, level: int = 6,
                          workers: int = 1,
                          pair_chunk: int = 16384) -> tuple[int, int]:
    """Columnar twin of :func:`align_pairs` over whole FASTQ batch pairs:
    ``align_batch`` for the placement and ``encode_records`` for emission —
    no per-read Python in the loop.  Returns ``(n_reads, n_unmapped)``.
    Record bytes are identical to the object path (tests pin digest
    parity).

    ``workers > 1`` fans the per-chunk align+encode compute (most of the
    leg's wall on one core) over a forked process pool; the parent writes
    each chunk's blobs as they complete, in submission order, through the
    one :class:`SortingBamWriter`.  Output bytes are IDENTICAL to the
    serial path regardless of ``workers``/``pair_chunk``: the writer's
    total order is content-keyed (rid, pos, qname, flag — never append
    order), which is the same property that lets the object and columnar
    paths byte-match.  ALL pool workers fork before the writer exists (a
    prestart barrier forces the executor's lazy spawns early), so no
    BGZF/codec thread state crosses any fork; the executor never re-forks
    replacements itself.  The port's CLI has imported torch before the
    fork; the children run numpy only and never touch torch or CUDA, and
    ``fastq2bam`` opens no CUDA context, so none is inherited.  A worker
    death (e.g. an OOM-kill on a large run) surfaces as BrokenProcessPool at the next drain;
    the run then re-forks the pool ONCE and replays the lost chunks, and
    on a second death finishes the remaining chunks serially in the
    parent — the content-keyed order makes replay byte-transparent.
    """
    from consensuscruncher_tpu_torch.io.bam import BamHeader
    from consensuscruncher_tpu_torch.io.columnar import SortingBamWriter
    from consensuscruncher_tpu_torch.io.encode import encode_records
    from consensuscruncher_tpu_torch.utils.phred import encode_seq

    global _POOL_ALIGNER, _POOL_EMIT_LUT, _POOL_PRESTART_BARRIER
    # TWO code spaces on purpose: alignment compares in _CODE space
    # (non-ACGT -> 255, so read-N over ref-N matches, exactly like
    # align()/_encode), while emission uses pipeline codes (N -> 4) for
    # encode_records' seq nibbles.
    emit_lut = encode_seq(np.arange(256, dtype=np.uint8).tobytes())
    header = BamHeader.from_refs(aligner.refs)
    n_total = n_unmapped = 0
    tasks = _align_tasks(r1, r2, pair_chunk)

    pool = None
    if workers > 1:
        pool = _start_pool(workers, aligner, emit_lut)

    from consensuscruncher_tpu_torch.io.columnar import single_writer_sort_buffer_bytes

    # The align leg holds exactly one sorting writer, so it may claim the
    # single-writer RAM budget: a large run's coordinate sort stays in
    # memory instead of spilling.
    writer = SortingBamWriter(out_bam, header, level=level,
                              max_raw_bytes=single_writer_sort_buffer_bytes())
    try:
        if pool is None:
            for task in tasks:
                blob1, blob2, un = _bucket_blobs(
                    aligner, encode_records, emit_lut, *task)
                n_total += 2 * len(task[0])
                n_unmapped += un
                writer.write_encoded(blob1)
                writer.write_encoded(blob2)
        else:
            from collections import deque
            from concurrent.futures.process import BrokenProcessPool

            pending: deque = deque()  # (future, task) — tasks kept for replay
            max_inflight = workers + 2
            refork_left = 1

            def run_serial(task):
                nonlocal n_unmapped
                blob1, blob2, un = _bucket_blobs(
                    aligner, encode_records, emit_lut, *task)
                n_unmapped += un
                writer.write_encoded(blob1)
                writer.write_encoded(blob2)

            def handle_pool_death(exc):
                # One worker death breaks EVERY in-flight future, so the
                # whole pending window must be replayed: re-fork the pool
                # once, and after a second death (or a failed re-fork
                # warm-up) finish in the parent.  Replay cannot duplicate
                # or reorder output — the writer's total order is
                # content-keyed and n_unmapped counts only at completion.
                nonlocal pool, refork_left
                global _POOL_ALIGNER, _POOL_EMIT_LUT, _POOL_PRESTART_BARRIER
                lost = [t for _f, t in pending]
                pending.clear()
                _shutdown_pool(pool, kill=True)
                pool = None
                _POOL_ALIGNER = _POOL_EMIT_LUT = _POOL_PRESTART_BARRIER = None
                if refork_left > 0:
                    refork_left -= 1
                    print(f"WARNING: align pool worker died ({exc!r}); "
                          f"re-forking once and replaying {len(lost)} "
                          "in-flight chunk(s)", file=sys.stderr, flush=True)
                    pool = _start_pool(workers, aligner, emit_lut)
                else:
                    print(f"WARNING: align pool died again ({exc!r}); "
                          "finishing the remaining chunks serially",
                          file=sys.stderr, flush=True)
                for t in lost:
                    submit_one(t)

            def submit_one(task):
                if pool is None:
                    run_serial(task)
                    return
                try:
                    pending.append((pool.submit(_pool_bucket_blobs, task), task))
                except BrokenProcessPool as e:
                    handle_pool_death(e)
                    if pool is None:
                        run_serial(task)
                    else:
                        pending.append((pool.submit(_pool_bucket_blobs, task), task))

            def drain_one():
                # result() raises BrokenProcessPool the moment any worker
                # dies (the executor marks every in-flight future) — recover
                # instead of blocking forever or aborting the run.
                nonlocal n_unmapped
                fut, task = pending.popleft()
                try:
                    blob1, blob2, un = fut.result()
                except BrokenProcessPool as e:
                    pending.appendleft((fut, task))  # still lost; replay it
                    handle_pool_death(e)
                    return
                n_unmapped += un
                writer.write_encoded(blob1)
                writer.write_encoded(blob2)

            for task in tasks:
                while pool is not None and len(pending) >= max_inflight:
                    drain_one()
                n_total += 2 * len(task[0])
                submit_one(task)
            while pending:
                drain_one()
    except BaseException:
        if pool is not None:
            _shutdown_pool(pool, kill=True)
            pool = None
            _POOL_ALIGNER = _POOL_EMIT_LUT = _POOL_PRESTART_BARRIER = None
        writer.abort()
        raise
    finally:
        if pool is not None:
            _shutdown_pool(pool, kill=False)
            _POOL_ALIGNER = _POOL_EMIT_LUT = _POOL_PRESTART_BARRIER = None
    writer.close()
    return n_total, n_unmapped


def _bucket_blobs(aligner, encode_records, emit_lut,
                  seq1, rq1, seq2, rq2, tok, tok_lens):
    """Align one equal-length chunk of pairs (raw seq/qual byte matrices)
    and build both mates' encoded record blobs.  Pure compute — no writer
    access — so it runs unchanged in a forked pool worker.  Returns
    ``(r1_blob, r2_blob, n_unmapped)``.
    """
    B, l1 = seq1.shape
    _, l2 = seq2.shape
    if B == 0:
        z = np.zeros(0, np.uint8)
        return z, z, 0
    # alignment space: non-ACGT -> 255 (see align_fastqs_columnar)
    codes1 = emit_lut[seq1]
    codes2 = emit_lut[seq2]
    acodes1 = _CODE[seq1]
    acodes2 = _CODE[seq2]
    qual1 = rq1 - 33
    qual2 = rq2 - 33
    h1 = aligner.align_batch(acodes1)
    h2 = aligner.align_batch(acodes2)

    m1, m2 = h1["mapped"], h2["mapped"]
    proper = m1 & m2 & (h1["ref_idx"] == h2["ref_idx"]) & (h1["reverse"] != h2["reverse"])
    # FR pair tlen: leftmost gets +, by align_pairs' exact tie rule
    lo = np.minimum(h1["pos"], h2["pos"])
    hi = np.maximum(h1["pos"] + l1, h2["pos"] + l2)
    span = np.where(proper, hi - lo, 0)
    tie = h1["pos"] == h2["pos"]
    tlen1 = np.where(proper, np.where(tie | (h1["pos"] == lo), span, -span), 0)
    tlen2 = np.where(proper, np.where(tie, -span,
                                      np.where(h2["pos"] == lo, span, -span)), 0)

    unmapped = 0
    blobs = []
    for this, mate, codes, qual, L, read1, tl in (
        (h1, h2, codes1, qual1, l1, True, tlen1),
        (h2, h1, codes2, qual2, l2, False, tlen2),
    ):
        tm, mm = this["mapped"], mate["mapped"]
        unmapped += int((~tm).sum())
        flag = np.full(B, 0x1 | (0x40 if read1 else 0x80), np.int32)
        flag |= np.where(proper, 0x2, 0)
        flag |= np.where(~tm, 0x4, 0)
        flag |= np.where(tm & this["reverse"], 0x10, 0)
        flag |= np.where(~mm, 0x8, 0)
        flag |= np.where(mm & mate["reverse"], 0x20, 0)
        rid = np.where(tm, this["ref_idx"], np.where(mm, mate["ref_idx"], -1))
        pos = np.where(tm, this["pos"], np.where(mm, mate["pos"], -1))
        mrid = np.where(mm, mate["ref_idx"], rid)
        mpos = np.where(mm, mate["pos"], pos)
        rev = tm & this["reverse"]
        out_codes = np.where(rev[:, None], _REVCOMP_LUT[codes[:, ::-1]], codes)
        out_qual = np.where(rev[:, None], qual[:, ::-1], qual)
        cig_lens = tm.astype(np.int64)
        cig_words = np.full(int(cig_lens.sum()), (L << 4) | 0, np.uint32)
        tag7 = np.zeros((B, 7), np.uint8)
        tag7[:, :3] = np.frombuffer(b"NMi", np.uint8)
        tag7[:, 3:] = this["nm"].astype("<i4").view(np.uint8).reshape(B, 4)
        tag_lens = np.where(tm, 7, 0).astype(np.int64)
        from consensuscruncher_tpu_torch.utils.ragged import gather_runs

        tok_data, _ = gather_runs(
            tok.reshape(-1),
            np.arange(B, dtype=np.int64) * tok.shape[1], tok_lens)
        blob = encode_records(
            tok_data,
            tok_lens,
            flag, rid.astype(np.int64), pos.astype(np.int64),
            np.where(tm, this["mapq"], 0).astype(np.int64),
            cig_words, cig_lens,
            mrid.astype(np.int64), mpos.astype(np.int64), tl.astype(np.int64),
            np.ascontiguousarray(out_codes).reshape(-1),
            np.full(B, L, np.int64),
            np.ascontiguousarray(out_qual).reshape(-1),
            tag7[tm].reshape(-1), tag_lens,
        )
        blobs.append(blob)
    return blobs[0], blobs[1], unmapped


def align_pairs(aligner: BuiltinAligner, pairs, header):
    """Yield ``BamRead`` pairs for ``(qname, s1, q1, s2, q2)`` tuples.

    Sets the reference's expected flag layout for FR proper pairs: paired +
    proper (both mates placed on the same ref, opposite strands), mate
    strand/position/tlen cross-filled, read1/read2 bits, and unmapped flags
    when a mate fails to place (such reads flow to badReads downstream).
    """
    from consensuscruncher_tpu_torch.io.bam import BamRead

    for qname, s1, q1, s2, q2 in pairs:
        h1, h2 = aligner.align(s1), aligner.align(s2)
        proper = (
            h1 is not None and h2 is not None and h1.ref == h2.ref
            and h1.reverse != h2.reverse
        )
        for this, mate, seq, qual, read1 in ((h1, h2, s1, q1, True), (h2, h1, s2, q2, False)):
            flag = 0x1 | (0x40 if read1 else 0x80)
            if proper:
                flag |= 0x2
            if this is None:
                flag |= 0x4
            elif this.reverse:
                flag |= 0x10
            if mate is None:
                flag |= 0x8
            elif mate.reverse:
                flag |= 0x20
            out_seq = revcomp(seq) if (this is not None and this.reverse) else seq
            out_qual = np.asarray(qual[::-1] if (this is not None and this.reverse) else qual,
                                  np.uint8)
            pos = this.pos if this is not None else (mate.pos if mate is not None else -1)
            ref = this.ref if this is not None else (mate.ref if mate is not None else None)
            mate_pos = mate.pos if mate is not None else pos
            mate_ref = mate.ref if mate is not None else ref
            tlen = 0
            if proper:
                lo = min(h1.pos, h2.pos)
                hi = max(h1.pos + len(s1), h2.pos + len(s2))
                if h1.pos == h2.pos:
                    # SAM convention: the two tlens must sum to zero — when
                    # both mates share the leftmost position, break the tie
                    # deterministically (read1 +, read2 -).
                    tlen = (hi - lo) if read1 else -(hi - lo)
                else:
                    tlen = (hi - lo) if this.pos == lo else -(hi - lo)
            yield BamRead(
                qname=qname,
                flag=flag,
                ref=ref, pos=pos,
                mapq=this.mapq if this is not None else 0,
                cigar=[("M", len(seq))] if this is not None else [],
                mate_ref=mate_ref, mate_pos=mate_pos, tlen=tlen,
                seq=out_seq, qual=out_qual,
                tags={"NM": ("i", this.nm)} if this is not None else {},
            )
