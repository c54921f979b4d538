"""Columnar BAM decode + sort (port of ``consensuscruncher_tpu/io/columnar.py``).

The per-record object path (``BamReader`` -> ``BamRead`` dataclasses)
pays pure-Python struct work for every record, and once the vote runs on
a card that host work is most of the pipeline's wall.  This module
decodes a whole batch of records into **columns** (numpy arrays) with a
single serial offset scan plus vectorized gathers, so per-record Python
work stays off the hot path.

Layout per batch (record fields per SAM spec §4.2):

- fixed-width columns: ``ref_id pos flag mapq mate_ref_id mate_pos tlen
  l_seq n_cigar l_qname`` — one numpy array each, shape ``(n,)``.
- ragged payloads are *views into the undecoded buffer* described by
  ``(start, length)`` column pairs; materialized on demand via
  :func:`ragged_gather` (qnames, cigars, tags) or the nibble-expanding
  :func:`seq_codes` (sequence -> pipeline base codes A=0..N=4).
- ``raw`` record blobs (length-prefixed, byte-exact) remain addressable via
  ``rec_off`` for passthrough writes — a coordinate sort is then a pure
  byte shuffle (lexsort + gather), never a decode/re-encode round trip.

Parity: every field agrees bit-for-bit with ``BamReader`` (the
reference's ``tests/test_columnar.py`` proves it for the copied code
record by record), and :func:`sort_bam_columnar` reproduces ``io.bam.sort_bam``'s exact total order — the same
``(ref_id, pos, qname, flag)`` key, stable for equal keys (np.lexsort and
Python sort are both stable).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple

import numpy as np

from consensuscruncher_tpu_torch.io import bgzf
from consensuscruncher_tpu_torch.io.bam import (
    BAM_MAGIC,
    BamHeader,
    CIGAR_OPS,
    SEQ_NIBBLES,
    decode_record,
    read_bam_header,
)
from consensuscruncher_tpu_torch.utils.manifest import commit_file
from consensuscruncher_tpu_torch.utils.phred import N as CODE_N, encode_seq  # noqa: F401
from consensuscruncher_tpu_torch.utils.ragged import gather_runs

# nibble (0-15, spec '=ACMGRSVTWYHKDBN') -> pipeline base code (A=0..N=4);
# every ambiguity code collapses to N exactly like decode->encode_seq does.
NIB2CODE = encode_seq(SEQ_NIBBLES)
# byte -> its two nibbles' codes (high nibble first), for paired expansion
NIB2CODE_PAIR = np.stack(
    [NIB2CODE[np.arange(256) >> 4], NIB2CODE[np.arange(256) & 0xF]], axis=1
).astype(np.uint8)


def _qname_key_matrix(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """``(n, W)`` zero-padded qname byte matrix scattered straight from the
    record buffer, with ``W`` rounded up to a multiple of 8 so
    :func:`coord_sort_perm`'s big-endian uint64 key view is zero-copy.
    Shared by ``ColumnarBatch.qname_matrix`` and ``SortingBamWriter``."""
    from consensuscruncher_tpu_torch.utils.ragged import scatter_runs

    n = len(starts)
    w = int(lens.max()) if n else 0
    w8 = -(-w // 8) * 8
    out = np.zeros((n, w8), dtype=np.uint8)
    if w:
        scatter_runs(out.reshape(-1), np.arange(n, dtype=np.int64) * w8,
                     buf, lens, src_starts=starts)
    return out


def _gather_view(buf: np.ndarray, off: np.ndarray, width: int, dtype: str) -> np.ndarray:
    """Vectorized unaligned little-endian field gather at ``off`` (n,)."""
    from consensuscruncher_tpu_torch.io import native

    if native.available():
        return native.gather_fixed(buf, off, width).view(dtype).ravel()
    raw = buf[off[:, None] + np.arange(width, dtype=np.int64)]
    return np.ascontiguousarray(raw).view(dtype).ravel()


def ragged_gather(buf: np.ndarray, starts: np.ndarray, lengths: np.ndarray):
    """Gather ``n`` variable-length byte runs into one packed array — the
    shared :func:`utils.ragged.gather_runs` under its historical name."""
    return gather_runs(buf, starts, lengths)


@dataclass
class ColumnarBatch:
    """One decoded batch; all arrays share the record axis ``(n,)``."""

    header: BamHeader
    buf: np.ndarray  # uint8: the uncompressed bytes these records live in
    rec_off: np.ndarray  # (n+1,) int64 record starts (at the length prefix)
    ref_id: np.ndarray
    pos: np.ndarray
    flag: np.ndarray
    mapq: np.ndarray
    mate_ref_id: np.ndarray
    mate_pos: np.ndarray
    tlen: np.ndarray
    l_seq: np.ndarray
    n_cigar: np.ndarray
    l_qname: np.ndarray  # includes the trailing NUL

    @property
    def n(self) -> int:
        return len(self.rec_off) - 1

    # ---- derived ragged payload geometry (all (n,) int64) ----

    @cached_property
    def qname_start(self) -> np.ndarray:
        return self.rec_off[:-1] + 36

    @cached_property
    def cigar_start(self) -> np.ndarray:
        return self.qname_start + self.l_qname

    @cached_property
    def seq_start(self) -> np.ndarray:
        return self.cigar_start + 4 * self.n_cigar.astype(np.int64)

    @cached_property
    def qual_start(self) -> np.ndarray:
        return self.seq_start + (self.l_seq.astype(np.int64) + 1) // 2

    @cached_property
    def tags_start(self) -> np.ndarray:
        return self.qual_start + self.l_seq

    # ---- materialized payloads ----

    @cached_property
    def qnames(self):
        """``(data, offsets)`` of qname bytes (no trailing NUL)."""
        return ragged_gather(self.buf, self.qname_start, self.l_qname - 1)

    @cached_property
    def qname_matrix(self) -> np.ndarray:
        """``(n, W)`` uint8, zero-padded past the batch's longest qname to a
        multiple of 8 — the vectorized-lexicographic form (NUL pads sort
        before any ascii byte, exactly like Python's shorter-string-first
        comparison; the 8-alignment makes the sort-key uint64 view free)."""
        return _qname_key_matrix(self.buf, self.qname_start, self.l_qname - 1)

    @cached_property
    def _seq_codes_cache(self):
        return self._seq_codes_impl()

    def seq_codes(self):
        """``(codes, offsets)``: 4-bit seq fields nibble-expanded straight to
        pipeline base codes (A=0..N=4) — no string round trip.  Cached: the
        block producer touches a batch from several sources."""
        return self._seq_codes_cache

    def _seq_codes_impl(self):
        l = self.l_seq.astype(np.int64)
        off = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(l, out=off[1:])
        total = int(off[-1])
        if total == 0:
            return np.empty(0, dtype=np.uint8), off
        # Fast path (reads overwhelmingly have even lengths): gather each
        # record's seq BYTES once and expand byte -> two codes via a (256, 2)
        # LUT — half the index math of per-nibble gathering.  A pad nibble
        # from an odd-length read would misalign everything after it, so any
        # odd length falls back to the per-nibble form.
        if not (l & 1).any():
            data, _ = ragged_gather(self.buf, self.seq_start, l >> 1)
            from consensuscruncher_tpu_torch.io import native

            if native.available():
                return native.expand_nibbles(data, NIB2CODE_PAIR), off
            return NIB2CODE_PAIR[data].reshape(-1), off
        rel = np.arange(total, dtype=np.int64) - np.repeat(off[:-1], l)
        byte_idx = np.repeat(self.seq_start, l) + rel // 2
        b = self.buf[byte_idx]
        nib = np.where(rel % 2 == 0, b >> 4, b & 0xF)
        return NIB2CODE[nib], off

    @cached_property
    def _quals_cache(self):
        return self._quals_impl()

    def quals(self):
        """``(quals, offsets)``; a read whose FIRST qual byte is the spec's
        0xFF missing marker decodes as all-zero — exactly ``decode_record``'s
        whole-read-missing rule (a stray mid-read 0xFF stays 255, so the
        columnar and object paths can never diverge on malformed input).
        Cached, like :meth:`seq_codes`."""
        return self._quals_cache

    def _quals_impl(self):
        data, off = ragged_gather(self.buf, self.qual_start, self.l_seq)
        l = self.l_seq.astype(np.int64)
        nonempty = l > 0
        first = np.zeros(self.n, dtype=np.uint8)
        first[nonempty] = self.buf[self.qual_start[nonempty]]
        missing = np.repeat(nonempty & (first == 0xFF), l)
        return np.where(missing, 0, data).astype(np.uint8), off

    def cigar_string(self, i: int) -> str:
        """Cigar of record ``i`` as text ('*' when empty)."""
        nc = int(self.n_cigar[i])
        if nc == 0:
            return "*"
        start = int(self.cigar_start[i])
        words = (
            np.ascontiguousarray(self.buf[start : start + 4 * nc]).view("<u4")
        )
        return "".join(f"{int(w) >> 4}{CIGAR_OPS[int(w) & 0xF]}" for w in words)

    def record_blob(self, i: int) -> bytes:
        """Byte-exact record ``i`` including the length prefix."""
        return self.buf[self.rec_off[i] : self.rec_off[i + 1]].tobytes()

    def materialize(self, i: int):
        """Full ``BamRead`` for record ``i`` (slow path: bad reads,
        singletons — anything that needs the object surface)."""
        body = self.buf[self.rec_off[i] + 4 : self.rec_off[i + 1]].tobytes()
        return decode_record(body, self.header)


def _scan_offsets(chunk: bytes, limit: int) -> np.ndarray:
    """Record boundaries in ``chunk[:limit]`` — the single serial pass
    (native C loop when the codec library is available)."""
    from consensuscruncher_tpu_torch.io import native

    if native.available():
        return native.scan_bam_records(chunk, limit)
    offs = [0]
    o = 0
    unpack_from = struct.unpack_from
    while o + 4 <= limit:
        (bs,) = unpack_from("<i", chunk, o)
        if bs < 32:
            raise ValueError(f"corrupt BAM record: block_size {bs} at offset {o}")
        if o + 4 + bs > limit:
            break
        o += 4 + bs
        offs.append(o)
    return np.asarray(offs, dtype=np.int64)


def _make_batch(header: BamHeader, buf: np.ndarray, rec_off: np.ndarray) -> ColumnarBatch:
    off = rec_off[:-1]
    return ColumnarBatch(
        header=header,
        buf=buf,
        rec_off=rec_off,
        ref_id=_gather_view(buf, off + 4, 4, "<i4"),
        pos=_gather_view(buf, off + 8, 4, "<i4"),
        l_qname=buf[off + 12].astype(np.int64),
        mapq=buf[off + 13].copy(),
        n_cigar=_gather_view(buf, off + 16, 2, "<u2").astype(np.int32),
        flag=_gather_view(buf, off + 18, 2, "<u2").astype(np.int32),
        l_seq=_gather_view(buf, off + 20, 4, "<i4"),
        mate_ref_id=_gather_view(buf, off + 24, 4, "<i4"),
        mate_pos=_gather_view(buf, off + 28, 4, "<i4"),
        tlen=_gather_view(buf, off + 32, 4, "<i4"),
    )


# Packed (rid, pos) ordering key for coordinate-sorted BAMs.  Unplaced
# records (rid < 0) sort last and all share the sentinel, so a range
# boundary can never split the unplaced tail.
UNPLACED_KEY = np.int64(1) << 62


def pack_coord_key(rid: int, pos: int) -> int:
    """Scalar (rid, pos) -> int64 ordering key (rid < 0 -> UNPLACED_KEY).
    pos clamps at 0: a placed-but-POS-less record (rid >= 0, pos == -1, the
    SAM-legal unmapped-with-RNAME shape) must not key below its rid."""
    return int(UNPLACED_KEY) if rid < 0 else ((int(rid) << 32) | max(int(pos), 0))


def pack_coord_keys(rid: np.ndarray, pos: np.ndarray) -> np.ndarray:
    rid64 = rid.astype(np.int64)
    return np.where(rid64 < 0, UNPLACED_KEY,
                    (rid64 << 32) | np.maximum(pos.astype(np.int64), 0))


class BamRange(NamedTuple):
    """Half-open coordinate range of a sorted BAM for direct index reads.

    ``start_voffset`` is a BAI virtual offset at or before the first record
    with key >= ``start_key`` (records before it are skipped); reading
    stops at the first record with key >= ``end_key`` (None = EOF,
    including the unplaced tail).  Used by ``--host_workers`` to read
    worker ranges straight out of the shared input (no materialized slice
    files).
    """

    start_voffset: int
    start_key: int
    end_key: int | None


def _slice_batch(header, batch, i: int, j: int):
    off = batch.rec_off
    lo, hi = int(off[i]), int(off[j])
    return _make_batch(header, batch.buf[lo:hi], off[i:j + 1] - off[i])


class ColumnarReader:
    """Streaming columnar BAM reader: ``for batch in reader.batches(): ...``

    ``batch_bytes`` bounds memory (uncompressed bytes per batch); records
    never split across batches.

    ``bam_range``: read only a :class:`BamRange` of a coordinate-sorted,
    path-addressed BAM — the header is decoded from the file start, then
    the stream re-opens at the range's virtual offset and batches are
    trimmed to the key range.
    """

    def __init__(self, path, batch_bytes: int = 64 << 20,
                 bam_range: BamRange | None = None):
        self._bgzf = bgzf.BgzfReader(path)
        self._batch_bytes = batch_bytes
        self.header = read_bam_header(self._bgzf)
        self._carry = b""
        self._range = bam_range
        self._start_pending = bam_range is not None
        if bam_range is not None and bam_range.start_voffset:
            # voffset 0 means "from the first record": the sequential
            # reader is already positioned right after the header.
            if not isinstance(path, (str, bytes, os.PathLike)):
                raise ValueError("bam_range requires a path-addressed BAM")
            self._bgzf.close()
            self._bgzf = bgzf.BgzfReader(path, start_voffset=bam_range.start_voffset)

    def batches(self):
        while True:
            chunk = self._carry + self._bgzf.read(self._batch_bytes)
            if not chunk:
                return
            offs = _scan_offsets(chunk, len(chunk))
            end = int(offs[-1])
            if end == 0:
                # no complete record in the window: either a giant record
                # (grow the read) or EOF mid-record (truncation)
                more = self._bgzf.read(self._batch_bytes)
                if not more:
                    raise ValueError("truncated BAM record at end of file")
                self._carry = chunk + more
                continue
            self._carry = chunk[end:]
            buf = np.frombuffer(chunk, dtype=np.uint8, count=end)
            batch = _make_batch(self.header, buf, offs)
            if self._range is not None:
                batch, done = self._trim(batch)
                if batch is not None and batch.n:
                    yield batch
                if done:
                    return
                continue
            yield batch

    def _trim(self, batch):
        """Apply the range's start/end key bounds to one batch.  Returns
        ``(trimmed_batch_or_None, done)``."""
        keys = pack_coord_keys(batch.ref_id, batch.pos)
        i = 0
        if self._start_pending:
            # keys ascend in a coordinate-sorted file; skip the prefix the
            # linear-index voffset conservatively included
            i = int(np.searchsorted(keys, self._range.start_key))
            if i < batch.n:
                self._start_pending = False
        if self._range.end_key is not None:
            j = int(np.searchsorted(keys, self._range.end_key))
            if j < batch.n:
                if j <= i:
                    return None, True
                return _slice_batch(self.header, batch, i, j), True
        if i >= batch.n:
            return None, False
        if i:
            return _slice_batch(self.header, batch, i, batch.n), False
        return batch, False

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ------------------------------------------------------------------ sort

def sort_bam_columnar(
    in_path,
    out_path,
    level: int = 6,
    max_records: int = 2_000_000,
    max_raw_bytes: int = 768 << 20,
) -> bool:
    """In-memory coordinate sort as a pure byte shuffle.

    Same total order as ``io.bam.sort_bam`` — key ``(ref_id_or_last, pos,
    qname, flag)``, stable — but the records are never decoded: lexsort the
    key columns, then gather the raw length-prefixed blobs in permuted
    order and stream them through BGZF.  Returns ``True`` on success,
    ``False`` when the input exceeds the in-memory bounds (record count or
    UNCOMPRESSED bytes — compressed size is no proxy: low-complexity reads
    BGZF-compress 10-30x), in which case the caller falls back to the
    bounded spill/merge object sort.
    """
    from consensuscruncher_tpu_torch.io.bam import _sorted_header

    reader = ColumnarReader(in_path, batch_bytes=64 << 20)
    batches = []
    n_total = 0
    raw_total = 0
    try:
        header = reader.header
        for b in reader.batches():
            batches.append(b)
            n_total += b.n
            raw_total += len(b.buf)
            if n_total > max_records or raw_total > max_raw_bytes:
                return False  # let the spill/merge path handle it
    finally:
        reader.close()

    # key columns across batches
    if n_total:
        rid = np.concatenate([b.ref_id for b in batches])
        pos = np.concatenate([b.pos for b in batches])
        flag = np.concatenate([b.flag for b in batches])
        w = max(b.qname_matrix.shape[1] for b in batches)
        qm = np.zeros((n_total, w), dtype=np.uint8)
        row = 0
        for b in batches:
            m = b.qname_matrix
            qm[row : row + b.n, : m.shape[1]] = m
            row += b.n
        perm = coord_sort_perm(rid, pos, qm, flag)
    else:
        perm = np.empty(0, dtype=np.int64)

    if n_total:
        starts = np.concatenate([b.rec_off[:-1] for b in batches])
        lengths = np.concatenate([np.diff(b.rec_off) for b in batches])
        # per-batch buffers -> one global buffer for the gather
        if len(batches) == 1:
            big = batches[0].buf
        else:
            base = np.zeros(len(batches), dtype=np.int64)
            sizes = [len(b.buf) for b in batches]
            base[1:] = np.cumsum(sizes[:-1])
            big = np.concatenate([b.buf for b in batches])
            rec_base = np.repeat(base, [b.n for b in batches])
            starts = starts + rec_base
        sp, lp = starts[perm], lengths[perm]
    else:
        big = np.empty(0, np.uint8)
        sp = lp = np.empty(0, np.int64)
    _write_bam_records(out_path, _sorted_header(header), big, sp, lp, level)
    return True


def coord_sort_perm(rid: np.ndarray, pos: np.ndarray, qname_matrix: np.ndarray,
                    flag: np.ndarray) -> np.ndarray:
    """THE samtools-parity coordinate total order, as a lexsort permutation:
    ``(ref_id with unmapped last, pos, qname bytes, flag)``, stable — the
    single columnar definition shared by ``sort_bam_columnar`` and
    ``SortingBamWriter`` (scalar twin: ``io.bam._coord_key``)."""
    rid = np.where(np.asarray(rid) < 0, 1 << 30, rid)
    n, w = qname_matrix.shape
    # Pack the zero-padded qname bytes into big-endian uint64 words: numeric
    # word order == lexicographic byte order, and the lexsort runs over
    # ~w/8 keys instead of w.
    w8 = max(8, -(-w // 8) * 8)
    if w8 == w and qname_matrix.flags.c_contiguous:
        qp = qname_matrix
    else:
        qp = np.zeros((n, w8), dtype=np.uint8)
        qp[:, :w] = qname_matrix
    packed = qp.view(">u8")
    # significance (most -> least): rid, pos, qname bytes, flag;
    # np.lexsort's primary key is the LAST element.
    keys = [flag] + [packed[:, i] for i in range(packed.shape[1] - 1, -1, -1)] + [pos, rid]
    return np.lexsort(keys)


class _ChunkRecordStream:
    """Sequential record-blob fetcher over a coordinate-sorted chunk BAM.

    ``fetch(n)`` returns the next ``n`` records' raw length-prefixed bytes
    as ``(data, lengths)`` — batches decode lazily, so only a window of the
    chunk is ever resident.  Building block of the columnar k-way merge.
    """

    def __init__(self, path):
        self._reader = ColumnarReader(path)
        self._batches = self._reader.batches()
        self._cur: list[tuple[np.ndarray, np.ndarray, int]] = []  # buf, off, ptr

    def fetch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        pieces: list[np.ndarray] = []
        lens: list[np.ndarray] = []
        need = n
        while need:
            if not self._cur:
                b = next(self._batches)  # StopIteration = caller bug
                self._cur.append((b.buf, b.rec_off, 0))
            buf, off, ptr = self._cur[0]
            avail = len(off) - 1 - ptr
            take = min(avail, need)
            lo, hi = int(off[ptr]), int(off[ptr + take])
            pieces.append(buf[lo:hi])
            lens.append(np.diff(off[ptr : ptr + take + 1]))
            need -= take
            if take == avail:
                self._cur.pop(0)
            else:
                self._cur[0] = (buf, off, ptr + take)
        data = pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
        lengths = lens[0] if len(lens) == 1 else np.concatenate(lens)
        return data, lengths

    def close(self) -> None:
        self._reader.close()


_MERGE_WRITE_BLOCK = 65536  # records interleaved per output write


def merge_sorted_columnar(paths: list, out_path, header: BamHeader,
                          level: int = 6, index: bool = True,
                          key_budget: int | None = None,
                          verify_sorted: bool = True) -> bool:
    """K-way merge of coordinate-sorted BAMs as a columnar byte shuffle.

    Replaces the object heap merge (BamReader -> BamRead -> heapq -> encode,
    several times slower end to end): load every
    input's KEY columns only (rid/pos/qname/flag + the BAI span columns),
    one stable global lexsort — np.lexsort over the concatenated keys
    reproduces the heap's earlier-input-wins tie order — then stream each
    input's raw record blobs sequentially and interleave them into the
    output in vectorized blocks.  Record bytes are never decoded; the
    ``.bai`` builds inline from the permuted span columns.

    Returns False (caller falls back to the heap merge) when the key
    columns would exceed ``key_budget`` bytes (default:
    :func:`_default_merge_key_budget` — independent of the record-buffer
    cap) — record bytes are streamed regardless, so the budget bounds only
    ~90 B/record of keys — or when ``verify_sorted`` finds an input whose
    physical order is not its full-key order (legal for samtools-sorted
    foreign BAMs with arbitrary coordinate-tie order; the interleave
    would corrupt such a file, the heap merge handles it).  Callers
    merging THIS framework's own outputs (full-key-sorted by
    construction) may pass ``verify_sorted=False`` to skip the check.
    """
    from consensuscruncher_tpu_torch.io.bam import _sorted_header
    from consensuscruncher_tpu_torch.utils.ragged import scatter_runs

    if key_budget is None:
        key_budget = _default_merge_key_budget()
    n_chunks = len(paths)
    rid_l, pos_l, flag_l, qm_l, lens_l = [], [], [], [], []
    end_l, mapped_l = [], []
    counts = np.zeros(n_chunks, dtype=np.int64)
    key_bytes = 0
    batch_bounds = [0]  # per-chunk [start, end) into the per-batch lists
    for ci, p in enumerate(paths):
        with ColumnarReader(p) as r:
            for b in r.batches():
                off = b.rec_off[:-1]
                rid_l.append(b.ref_id.astype(np.int64))
                pos_l.append(b.pos.astype(np.int64))
                flag_l.append(b.flag.astype(np.int64))
                qm_l.append(b.qname_matrix)
                lens_l.append(np.diff(b.rec_off))
                if index:
                    _rid, _pos, end, mapped = _record_spans_columnar(b.buf, off)
                    end_l.append(end)
                    mapped_l.append(mapped)
                counts[ci] += b.n
                key_bytes += b.n * 40 + b.qname_matrix.size + (9 * b.n if index else 0)
                if key_bytes > key_budget:
                    return False
        batch_bounds.append(len(rid_l))
    n_total = int(counts.sum())
    qw = max((m.shape[1] for m in qm_l), default=0)
    # Charge the REAL peak, not just the per-batch sum: the zero-padded
    # global qname matrix coexists with the per-batch pieces while filling,
    # and perm/src/out_lens/chunk_of add ~28 B/record.
    if key_bytes + n_total * (qw + 28) > key_budget:
        return False

    if verify_sorted and n_total:
        # The interleave assumes each input's PHYSICAL record order is its
        # full (rid, pos, qname, flag) key order — true for every BAM this
        # framework writes, but samtools guarantees only (rid, pos) order
        # with arbitrary tie order, and a tie-misordered foreign input
        # would get other records' lengths scattered over its blobs (a
        # corrupt BAM, not just a misordering).  Verify per input; any
        # violation -> decline, the record-decoding heap merge handles it.
        for ci in range(n_chunks):
            n_c = int(counts[ci])
            if n_c <= 1:
                continue
            i0, i1 = batch_bounds[ci], batch_bounds[ci + 1]
            rid_c = np.concatenate(rid_l[i0:i1])
            pos_c = np.concatenate(pos_l[i0:i1])
            flag_c = np.concatenate(flag_l[i0:i1])
            w_c = max(m.shape[1] for m in qm_l[i0:i1])
            qm_c = np.zeros((n_c, w_c), dtype=np.uint8)
            r = 0
            for m in qm_l[i0:i1]:
                qm_c[r : r + len(m), : m.shape[1]] = m
                r += len(m)
            if not np.array_equal(coord_sort_perm(rid_c, pos_c, qm_c, flag_c),
                                  np.arange(n_c)):
                return False

    tmp = os.fspath(out_path) + ".tmp"
    out_header = _sorted_header(header)
    writer = bgzf.BgzfWriter(tmp, level=level, collect_blocks=index)
    streams: list[_ChunkRecordStream] = []
    try:
        text = out_header.text.encode("ascii")
        head = bytearray(BAM_MAGIC)
        head += struct.pack("<i", len(text)) + text
        head += struct.pack("<i", len(out_header.refs))
        for name, length in out_header.refs:
            bname = name.encode("ascii") + b"\x00"
            head += struct.pack("<i", len(bname)) + bname + struct.pack("<i", length)
        writer.write(bytes(head))

        if n_total:
            rid = np.concatenate(rid_l)
            pos = np.concatenate(pos_l)
            flag = np.concatenate(flag_l)
            lengths = np.concatenate(lens_l)
            w = max(m.shape[1] for m in qm_l)
            qm = np.zeros((n_total, w), dtype=np.uint8)
            row = 0
            for m in qm_l:
                qm[row : row + len(m), : m.shape[1]] = m
                row += len(m)
            del qm_l
            perm = coord_sort_perm(rid, pos, qm, flag)
            del qm
            chunk_of = np.repeat(np.arange(n_chunks), counts).astype(np.int32)
            src = chunk_of[perm]
            out_lens = lengths[perm]

            streams = [_ChunkRecordStream(p) for p in paths]
            for i0 in range(0, n_total, _MERGE_WRITE_BLOCK):
                i1 = min(i0 + _MERGE_WRITE_BLOCK, n_total)
                src_b = src[i0:i1]
                lens_b = out_lens[i0:i1]
                starts_b = np.zeros(len(lens_b), dtype=np.int64)
                np.cumsum(lens_b[:-1], out=starts_b[1:])
                out_buf = np.empty(int(lens_b.sum()), dtype=np.uint8)
                for ci in range(n_chunks):
                    slots = np.nonzero(src_b == ci)[0]
                    if not slots.size:
                        continue
                    # slots appear in chunk-sequential order (the global
                    # sort preserves each sorted input's internal order)
                    data, dlens = streams[ci].fetch(len(slots))
                    scatter_runs(out_buf, starts_b[slots], data, dlens)
                writer.write(out_buf.tobytes())
        writer.close()
        commit_file(tmp, out_path)
    except BaseException:
        # cleanup must not mask the root cause: an async writer close()
        # re-raises its deferred worker error — suppress it here, the
        # original exception is the one that matters
        try:
            writer.close()
        except Exception:
            pass
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    finally:
        for s in streams:
            s.close()

    if index:
        from consensuscruncher_tpu_torch.io.bai import write_bai_from_columns

        if n_total:
            end = np.concatenate(end_l)
            mapped = np.concatenate(mapped_l)
            rid_p, pos_p = rid[perm], pos[perm]
            end_p, mapped_p = end[perm], mapped[perm]
            ustart = len(head) + np.concatenate(
                [[0], np.cumsum(out_lens[:-1], dtype=np.int64)])
        else:
            rid_p = pos_p = end_p = ustart = np.zeros(0, np.int64)
            mapped_p = np.zeros(0, bool)
            out_lens = np.zeros(0, np.int64)
        write_bai_from_columns(
            os.fspath(out_path) + ".bai", len(out_header.refs),
            rid_p, pos_p, end_p, mapped_p, ustart, ustart + out_lens,
            writer.block_sizes,
        )
    return True


def _record_spans_columnar(big: np.ndarray, starts: np.ndarray):
    """(rid, pos, end, mapped) per record, vectorized (the columnar twin of
    ``io.bai._record_span``): end = pos + ref-consumed cigar length (min 1),
    pos + 1 for unmapped or cigar-less records."""
    off = starts
    rid = _gather_view(big, off + 4, 4, "<i4").astype(np.int64)
    pos = _gather_view(big, off + 8, 4, "<i4").astype(np.int64)
    flag = _gather_view(big, off + 18, 2, "<u2")
    n_cig = _gather_view(big, off + 16, 2, "<u2").astype(np.int64)
    l_qname = big[off + 12].astype(np.int64)
    mapped = (flag & 0x4) == 0
    end = pos + 1
    use = mapped & (n_cig > 0)
    if use.any():
        data, coff = ragged_gather(big, (off + 36 + l_qname)[use], 4 * n_cig[use])
        words = np.ascontiguousarray(data).view("<u4").astype(np.int64)
        ops = words & 0xF
        # ref-consuming ops: M, D, N, =, X  (0, 2, 3, 7, 8)
        contrib = np.where(
            (ops == 0) | (ops == 2) | (ops == 3) | (ops == 7) | (ops == 8),
            words >> 4, 0,
        )
        cs = np.concatenate([[0], np.cumsum(contrib)])
        wb = coff // 4
        ref_len = cs[wb[1:]] - cs[wb[:-1]]
        end[use] = pos[use] + np.maximum(ref_len, 1)
    return rid, pos, end, mapped


def _write_bam_records(out_path, header: BamHeader, big: np.ndarray,
                       starts: np.ndarray, lengths: np.ndarray, level: int,
                       index: bool = True) -> None:
    """Atomically write header + the records ``big[starts[i]:+lengths[i]]``
    (already in final order) as a BGZF BAM.

    With ``index=True`` (default) the ``.bai`` sidecar is built inline from
    the same in-memory columns and the writer's block layout, so no
    ``index_bam`` re-read and per-record Python scan of files this
    function has just written.
    """
    tmp = os.fspath(out_path) + ".tmp"
    writer = bgzf.BgzfWriter(tmp, level=level, collect_blocks=index)
    try:
        text = header.text.encode("ascii")
        out = bytearray(BAM_MAGIC)
        out += struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(header.refs))
        for name, length in header.refs:
            bname = name.encode("ascii") + b"\x00"
            out += struct.pack("<i", len(bname)) + bname + struct.pack("<i", length)
        writer.write(bytes(out))
        header_len = len(out)
        n_total = len(starts)
        if n_total:
            # Gather + write in bounded record chunks: ragged_gather builds
            # per-record index state, so one whole-file gather would
            # transiently need far more memory than the data itself.
            csum = np.cumsum(lengths)
            target = 8 << 20
            i0 = 0
            while i0 < n_total:
                floor = int(csum[i0 - 1]) if i0 else 0
                i1 = int(np.searchsorted(csum, floor + target)) + 1
                i1 = min(max(i1, i0 + 1), n_total)
                data, _ = ragged_gather(big, starts[i0:i1], lengths[i0:i1])
                writer.write(data.tobytes())
                i0 = i1
        writer.close()
        commit_file(tmp, out_path)
    except BaseException:
        # cleanup must not mask the root cause: an async writer close()
        # re-raises its deferred worker error — suppress it here, the
        # original exception is the one that matters
        try:
            writer.close()
        except Exception:
            pass
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if index:
        from consensuscruncher_tpu_torch.io.bai import write_bai_from_columns

        rid, pos, end, mapped = _record_spans_columnar(big, starts)
        ustart = header_len + np.concatenate(
            [[0], np.cumsum(lengths[:-1], dtype=np.int64)]
        ) if len(starts) else np.zeros(0, np.int64)
        write_bai_from_columns(
            os.fspath(out_path) + ".bai", len(header.refs),
            rid, pos, end, mapped, ustart, ustart + lengths,
            writer.block_sizes,
        )


def _mem_available_bytes() -> int:
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def _sort_buffer_bytes(divisor: int) -> int:
    """Shared CCT_SORT_BUFFER_MAX_BYTES semantics: env override wins
    outright, else MemAvailable/divisor with a 4 GiB floor."""
    env = os.environ.get("CCT_SORT_BUFFER_MAX_BYTES")
    if env:
        return int(env)
    return max(4 << 30, _mem_available_bytes() // divisor)


def single_writer_sort_buffer_bytes() -> int:
    """Sort budget for a stage that holds exactly ONE sorting writer (the
    fastq2bam align leg): the multi-writer /8 headroom of
    :func:`_default_sort_buffer_bytes` is over-conservative there.  /3
    keeps the ~2x close() transient inside available RAM with margin.
    """
    return _sort_buffer_bytes(3)


def _default_sort_buffer_bytes() -> int:
    """Per-writer in-memory sort budget: env override, else RAM-aware.

    Spilling is DRAMATICALLY slower than buffering (the spill path finishes
    through the chunked merge), so the
    cap should be as high as the host can actually afford, not a fixed
    conservative number.  Budget: a stage holds 2-3 sorting writers at once
    and close() transiently needs ~2x the buffered bytes (concat + key
    columns + gathered output chunks), so a per-writer cap of
    MemAvailable/8 keeps a worst-case stage within available RAM.  Floor
    4 GiB (the old fixed default); the env var wins outright when set.
    """
    return _sort_buffer_bytes(8)


def _default_merge_key_budget() -> int:
    """Key-column budget for :func:`merge_sorted_columnar` — deliberately
    INDEPENDENT of CCT_SORT_BUFFER_MAX_BYTES: keys are ~30x smaller than
    raw record bytes, so a host too small to buffer records in full can
    still afford the columnar merge (that's exactly when it matters)."""
    env = os.environ.get("CCT_MERGE_KEY_BUDGET_BYTES")
    if env:
        return int(env)
    return max(1 << 30, _mem_available_bytes() // 8)


class SortingBamWriter:
    """Coordinate-sorting BAM writer: records buffer in memory as raw
    length-prefixed blobs and are key-decoded + lexsorted + written once at
    ``close()`` — no unsorted temp file, no BGZF round trip (the stage
    pattern this replaces was write-L1-tmp -> inflate -> sort -> deflate-L6).

    Same total order as ``io.bam.sort_bam`` (rid-with-unmapped-last, pos,
    qname bytes, flag; stable).  Inputs beyond ``max_raw_bytes`` of raw
    record data spill to an L1 temp BAM and finish through ``sort_bam``'s
    bounded merge path, so memory stays bounded on any input.

    Drop-in for the ``BamWriter`` surface the stages use: ``write``,
    ``write_encoded``, ``close``, ``abort`` (abort discards everything; the
    final path is never touched before a successful close).
    """

    def __init__(self, path, header: BamHeader, level: int = 6,
                 max_raw_bytes: int | None = None, index: bool = True):
        from consensuscruncher_tpu_torch.io.bam import _sorted_header

        if max_raw_bytes is None:
            max_raw_bytes = _default_sort_buffer_bytes()
        self._path = os.fspath(path)
        self.header = _sorted_header(header)
        self._level = level
        self._index = index
        self._max_raw = max_raw_bytes
        self._chunks: list[np.ndarray] = []
        self._raw = 0
        self._spill = None
        self._spill_path = self._path + ".unsorted.tmp"
        self._closed = False

    def write(self, read) -> None:
        from consensuscruncher_tpu_torch.io.bam import encode_record

        self.write_encoded(encode_record(read, self.header))

    def write_encoded(self, blob) -> None:
        if isinstance(blob, np.ndarray):
            arr = np.ascontiguousarray(blob, dtype=np.uint8)
        else:
            arr = np.frombuffer(blob, dtype=np.uint8)
        if arr.size == 0:
            return
        if self._spill is not None:
            self._spill.write_encoded(arr)
            return
        self._chunks.append(arr)
        self._raw += arr.size
        if self._raw > self._max_raw:
            self._start_spill()

    def _start_spill(self) -> None:
        from consensuscruncher_tpu_torch.io.bam import BamWriter

        self._spill = BamWriter(self._spill_path, self.header, level=1)
        for c in self._chunks:
            self._spill.write_encoded(c)
        self._chunks = []
        self._raw = 0

    def _sorted_columns(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Concatenate the buffered chunks and resolve the final write
        order: ``(big, starts, lengths)`` with records at
        ``big[starts[i] : starts[i] + lengths[i]]`` already sorted."""
        if not self._chunks:
            big = np.empty(0, np.uint8)
        elif len(self._chunks) == 1:
            big = self._chunks[0]
        else:
            big = np.concatenate(self._chunks)
        self._chunks = []
        rec_off = _scan_offsets(big, len(big))
        if int(rec_off[-1]) != len(big):
            raise ValueError("SortingBamWriter received a partial record")
        off = rec_off[:-1]
        n = len(off)
        if n:
            rid = _gather_view(big, off + 4, 4, "<i4").astype(np.int64)
            pos = _gather_view(big, off + 8, 4, "<i4")
            flag = _gather_view(big, off + 18, 2, "<u2")
            l_qname = big[off + 12].astype(np.int64)  # incl. NUL
            qm = _qname_key_matrix(big, off + 36, l_qname - 1)
            perm = coord_sort_perm(rid, pos, qm, flag)
            starts, lengths = off[perm], np.diff(rec_off)[perm]
        else:
            starts = lengths = np.empty(0, np.int64)
        return big, starts, lengths

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._spill is not None:
            from consensuscruncher_tpu_torch.io.bam import sort_bam

            self._spill.close()
            try:
                sort_bam(self._spill_path, self._path, level=self._level)
            finally:
                if os.path.exists(self._spill_path):
                    os.unlink(self._spill_path)
            return
        big, starts, lengths = self._sorted_columns()
        _write_bam_records(self._path, self.header, big, starts, lengths,
                           self._level, index=self._index)

    def close_to_memory(self) -> "MemoryBam":
        """Finish the sort WITHOUT writing the file: the streaming
        pipeline's stage hand-off.  The returned :class:`MemoryBam` holds
        the records in exactly the order and bytes :meth:`close` would
        have written, so materializing it later (final output or debug
        tap) is byte-identical to the staged path.

        Raises ``core.streamgraph.StreamFallback`` when the writer spilled —
        past the in-memory budget the staged sort/merge path is the only
        bounded one, and the CLI re-runs the staged pipeline on it.
        """
        from consensuscruncher_tpu_torch.core.streamgraph import StreamFallback

        if self._closed:
            raise RuntimeError("SortingBamWriter is already closed")
        if self._spill is not None:
            raise StreamFallback(
                "sort buffer spilled to disk; in-memory stage hand-off "
                "unavailable (falling back to the staged pipeline)")
        self._closed = True
        big, starts, lengths = self._sorted_columns()
        return MemoryBam(self.header, big, starts, lengths)

    def abort(self) -> None:
        self._closed = True
        self._chunks = []
        if self._spill is not None:
            self._spill.abort()
            if os.path.exists(self._spill_path):
                os.unlink(self._spill_path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class MemoryBam:
    """A sorted BAM held as in-memory columns — the streaming pipeline's
    inter-stage currency.

    Produced by :meth:`SortingBamWriter.close_to_memory`; consumed either
    as record batches (``.batches()`` — duck-compatible with
    :class:`ColumnarReader` so unchanged stage code reads it), as raw
    sorted record blobs (``.record_blobs()`` — what in-memory merges feed
    to ``write_encoded``), or materialized to disk (``.write()`` — the
    exact ``_write_bam_records`` call the staged path makes, hence
    byte-identical files).  Re-iterable and read-only; ``close()`` is a
    no-op so sources can be consumed more than once (e.g. SSCS feeds both
    singleton rescue and the final all-unique merge).
    """

    def __init__(self, header: BamHeader, big: np.ndarray,
                 starts: np.ndarray, lengths: np.ndarray):
        self.header = header
        self._big = big
        self._starts = starts
        self._lengths = lengths

    @property
    def n(self) -> int:
        return len(self._starts)

    @property
    def nbytes(self) -> int:
        return int(self._lengths.sum()) if len(self._lengths) else 0

    def _chunk_ranges(self, target: int):
        n = len(self._starts)
        if not n:
            return
        csum = np.cumsum(self._lengths)
        i0 = 0
        while i0 < n:
            floor = int(csum[i0 - 1]) if i0 else 0
            i1 = int(np.searchsorted(csum, floor + target)) + 1
            yield i0, min(max(i1, i0 + 1), n)
            i0 = min(max(i1, i0 + 1), n)

    def batches(self, batch_bytes: int = 64 << 20):
        """Yield :class:`ColumnarBatch` views in sorted order, bounded at
        ``batch_bytes`` of record data per batch."""
        for i0, i1 in self._chunk_ranges(batch_bytes):
            data, off = ragged_gather(
                self._big, self._starts[i0:i1], self._lengths[i0:i1])
            yield _make_batch(self.header, data, off)

    def record_blobs(self, chunk_bytes: int = 8 << 20):
        """Yield the sorted records as contiguous uint8 chunks (record
        boundaries never split) — the ``write_encoded`` feed shape."""
        for i0, i1 in self._chunk_ranges(chunk_bytes):
            data, _ = ragged_gather(
                self._big, self._starts[i0:i1], self._lengths[i0:i1])
            yield data

    def write(self, path, level: int = 6, index: bool = True) -> None:
        """Materialize to ``path`` exactly as the staged writer would have
        (atomic tmp+rename; inline ``.bai`` when ``index``)."""
        _write_bam_records(path, self.header, self._big, self._starts,
                           self._lengths, level, index=index)

    def close(self) -> None:
        pass


def open_batch_source(src, batch_bytes: int = 64 << 20):
    """A path OR an in-memory source -> something with ``.header`` /
    ``.batches()`` / ``.close()``.

    Stage code calls this instead of constructing :class:`ColumnarReader`
    directly, so the streaming pipeline can hand stages a
    :class:`MemoryBam` (or a read-ahead ``BatchStream`` over one)
    transparently while the staged path keeps passing file paths.
    """
    if hasattr(src, "batches") and hasattr(src, "header"):
        return src
    return ColumnarReader(src, batch_bytes=batch_bytes)
