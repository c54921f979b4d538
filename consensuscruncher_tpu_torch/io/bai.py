"""BAI index: build (``samtools index`` parity) and random-access fetch
(``pysam.AlignmentFile.fetch`` parity).

The reference pipeline runs ``samtools index`` after every sort and then
streams regions per chromosome through ``pysam.fetch``
(SURVEY.md §1 "External tools", §3.2).  Neither tool exists in this
image, and the rebuild's reader is first-party — so the index is too.
Format: SAM spec §5.2 (UCSC R-tree binning + 16 kb linear index, virtual
file offsets ``coffset << 16 | uoffset``), including the samtools
metadata pseudo-bin 37450 and the trailing no-coordinate count.

Parity is SEMANTIC (identical fetch results, fuzz-tested against a linear
scan), not byte-level vs ``samtools index``: a record starting exactly at a
BGZF block boundary is anchored here as ``(next_coffset << 16) | 0`` while
htslib records ``(prev_coffset << 16) | prev_block_len`` — both address the
same byte; the only observable difference is that htslib's chunk coalescing
fires slightly more often across block boundaries.

Everything here is host-side I/O; nothing touches the device.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

from consensuscruncher_tpu_torch.io import bgzf
from consensuscruncher_tpu_torch.io.bam import BAM_MAGIC, BamHeader, BamReader, decode_record
from consensuscruncher_tpu_torch.utils.manifest import commit_file

BAI_MAGIC = b"BAI\x01"
_PSEUDO_BIN = 37450  # samtools metadata bin (bin(4681,8191) + 1 + ...)
_LINEAR_SHIFT = 14  # 16 kb linear-index windows
# CIGAR ops that consume reference: M, D, N, =, X  (spec order MIDNSHP=X)
_REF_CONSUMING = frozenset(b"MDN=X".decode())
_CIGAR_OPS = "MIDNSHP=X"


def reg2bin(beg: int, end: int) -> int:
    """SAM spec §5.3 bin for a [beg, end) interval."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins that may hold records overlapping [beg, end) (spec §5.3)."""
    bins = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


@dataclass
class _RefIndex:
    bins: dict[int, list[list[int]]] = field(default_factory=dict)  # bin -> [[beg,end]...]
    linear: list[int] = field(default_factory=list)  # 16kb window -> min voffset
    n_mapped: int = 0
    n_unmapped: int = 0
    off_beg: int = -1
    off_end: int = 0

    def add(self, beg: int, end: int, vbeg: int, vend: int, mapped: bool) -> None:
        if self.off_beg < 0:
            self.off_beg = vbeg
        self.off_end = vend
        if mapped:
            self.n_mapped += 1
        else:
            self.n_unmapped += 1
        chunks = self.bins.setdefault(reg2bin(beg, end), [])
        # htslib merge rule: coalesce with the previous chunk when the new
        # one starts in the same compressed block the previous one ends in.
        if chunks and chunks[-1][1] >> 16 == vbeg >> 16:
            chunks[-1][1] = vend
        else:
            chunks.append([vbeg, vend])
        w_beg, w_end = beg >> _LINEAR_SHIFT, max(beg, end - 1) >> _LINEAR_SHIFT
        if len(self.linear) <= w_end:
            self.linear.extend([0] * (w_end + 1 - len(self.linear)))
        for w in range(w_beg, w_end + 1):
            if self.linear[w] == 0:
                self.linear[w] = vbeg


class _VoffsetTracker:
    """Maps global uncompressed offsets to virtual file offsets while
    streaming blocks in order.  Blocks are registered monotonically; lookups
    are monotonic too, so spent anchors are dropped as we go."""

    def __init__(self):
        self._anchors: list[tuple[int, int, int]] = []  # (u_start, coffset, len)

    def add_block(self, u_start: int, coffset: int, length: int) -> None:
        self._anchors.append((u_start, coffset, length))

    def voffset(self, u: int) -> int:
        """Virtual offset of global uncompressed position ``u``.  Positions
        at a block boundary resolve into the LATER block (a record never
        starts in the spent tail of a block)."""
        while len(self._anchors) > 1 and self._anchors[1][0] <= u:
            self._anchors.pop(0)
        u_start, coffset, _len = self._anchors[0]
        if u < u_start:
            raise ValueError("voffset lookups must be monotonic")
        return (coffset << 16) | (u - u_start)

    def voffset_end(self, u_end: int) -> int:
        """Virtual offset just past a record ending at global position
        ``u_end`` — stays in the block holding the record's last byte (so a
        record ending exactly at a block boundary gets uoffset == block
        length, matching htslib's post-read file-pointer convention)."""
        while len(self._anchors) > 1 and self._anchors[1][0] <= u_end - 1:
            self._anchors.pop(0)
        u_start, coffset, _len = self._anchors[0]
        return (coffset << 16) | (u_end - u_start)


def _record_span(body: bytes) -> tuple[int, int, int, bool]:
    """(ref_id, pos, end, mapped) from a raw record body (no full decode)."""
    ref_id, pos = struct.unpack_from("<ii", body, 0)
    l_read_name = body[8]
    (n_cigar,) = struct.unpack_from("<H", body, 12)
    (flag,) = struct.unpack_from("<H", body, 14)
    mapped = (flag & 0x4) == 0
    end = pos + 1
    if mapped and n_cigar:
        off = 32 + l_read_name
        ref_len = 0
        for i in range(n_cigar):
            (v,) = struct.unpack_from("<I", body, off + 4 * i)
            if _CIGAR_OPS[v & 0xF] in _REF_CONSUMING:
                ref_len += v >> 4
        end = pos + max(ref_len, 1)
    return ref_id, pos, end, mapped


def index_bam(bam_path, bai_path=None, skip_if_fresh: bool = False) -> str:
    """Build ``<bam>.bai`` for a coordinate-sorted BAM.  Returns the path.

    ``skip_if_fresh``: return without re-reading the BAM when the index
    already exists and is at least as new as it (the --resume fast path —
    indexing re-inflates the whole file, so it must not defeat skip-if-
    intact runs)."""
    bam_path = os.fspath(bam_path)
    bai_path = bai_path or bam_path + ".bai"
    if (skip_if_fresh and os.path.exists(bai_path)
            and os.path.getmtime(bai_path) >= os.path.getmtime(bam_path)):
        return bai_path

    refs: list[_RefIndex] = []
    n_no_coor = 0
    tracker = _VoffsetTracker()
    last_ref, last_pos = -1, -1

    with open(bam_path, "rb") as fh:
        # Walk raw blocks so every record's virtual offset is known.
        blocks = bgzf.iter_blocks_with_offsets(fh)
        buf = bytearray()
        buf_u = 0  # global uncompressed offset of buf[0]
        eof = False

        def fill(need: int) -> bool:
            nonlocal eof
            while len(buf) < need and not eof:
                try:
                    coffset, payload = next(blocks)
                except StopIteration:
                    eof = True
                    return len(buf) >= need
                tracker.add_block(buf_u + len(buf), coffset, len(payload))
                buf.extend(payload)
            return len(buf) >= need

        def take(n: int) -> bytes:
            nonlocal buf, buf_u
            out = bytes(buf[:n])
            del buf[:n]
            buf_u += n
            return out

        # Header: magic, text, refs — indexed content starts after it.
        if not fill(12):
            raise ValueError("truncated BAM header")
        if bytes(buf[:4]) != BAM_MAGIC:
            raise ValueError(f"not a BAM file: {bam_path!r}")
        (l_text,) = struct.unpack_from("<i", buf, 4)
        if not fill(12 + l_text):
            raise ValueError("truncated BAM header")
        take(8 + l_text)
        (n_ref,) = struct.unpack("<i", take(4))
        for _ in range(n_ref):
            if not fill(8):
                raise ValueError("truncated BAM header")
            (l_name,) = struct.unpack("<i", take(4))
            if not fill(l_name + 4):
                raise ValueError("truncated BAM header")
            take(l_name + 4)
            refs.append(_RefIndex())

        while True:
            if not fill(4):
                break
            (block_size,) = struct.unpack("<i", bytes(buf[:4]))
            if not fill(4 + block_size):
                raise ValueError("truncated BAM record")
            vbeg = tracker.voffset(buf_u)
            body = take(4 + block_size)[4:]
            vend = tracker.voffset_end(buf_u)
            ref_id, pos, end, mapped = _record_span(body)
            if ref_id < 0:
                n_no_coor += 1
                continue
            if ref_id < last_ref or (ref_id == last_ref and pos < last_pos):
                raise ValueError(
                    f"{bam_path!r} is not coordinate-sorted "
                    f"(ref {ref_id} pos {pos} after ref {last_ref} pos {last_pos})"
                )
            last_ref, last_pos = ref_id, pos
            refs[ref_id].add(pos, end, vbeg, vend, mapped)

    return _finish_and_write_bai(refs, n_no_coor, bai_path)


def _reg2bin_vec(beg, end):
    """Vectorized :func:`reg2bin` over (beg, end) column arrays."""
    import numpy as np

    e = end - 1
    conds = [beg >> 14 == e >> 14, beg >> 17 == e >> 17, beg >> 20 == e >> 20,
             beg >> 23 == e >> 23, beg >> 26 == e >> 26]
    choices = [4681 + (beg >> 14), 585 + (beg >> 17), 73 + (beg >> 20),
               9 + (beg >> 23), 1 + (beg >> 26)]
    return np.select(conds, choices, default=0)


def write_bai_from_columns(
    bai_path,
    n_ref: int,
    rid,
    pos,
    end,
    mapped,
    ustart,
    uend,
    block_csizes,
) -> str:
    """Build a .bai directly from write-time columns — no file re-read.

    The columnar writers (`io.columnar._write_bam_records`) know every
    record's byte range in the uncompressed stream and the BGZF block
    layout they produced (all payload blocks are exactly MAX_BLOCK_PAYLOAD
    bytes except the final one, so virtual offsets are pure arithmetic over
    the per-block compressed sizes).  ``index_bam``'s re-read + per-record
    Python scan was the single largest host cost of the CLI pipeline after
    the stages themselves.

    Args: ``rid``/``pos``/``end``/``mapped`` per record IN FILE ORDER
    (coordinate-sorted; rid < 0 = unplaced, counted into n_no_coor),
    ``end`` the reference-consumed end (pos+1 minimum), ``ustart``/``uend``
    the record's absolute uncompressed byte span (header included),
    ``block_csizes`` the compressed payload-block sizes in order.

    Semantics identical to :func:`index_bam` by the parity test suite.
    """
    import numpy as np

    P = bgzf.MAX_BLOCK_PAYLOAD
    rid = np.asarray(rid, dtype=np.int64)
    pos = np.asarray(pos, dtype=np.int64)
    end = np.asarray(end, dtype=np.int64)
    mapped = np.asarray(mapped, dtype=bool)
    ustart = np.asarray(ustart, dtype=np.int64)
    uend = np.asarray(uend, dtype=np.int64)

    coff = np.zeros(len(block_csizes) + 1, dtype=np.int64)
    np.cumsum(np.asarray(block_csizes, dtype=np.int64), out=coff[1:])
    # The voffset math below assumes every non-final BGZF payload block is
    # exactly P uncompressed bytes (BgzfWriter's flush invariant).  Nothing
    # else cross-checks it at runtime, and a future writer flush change
    # would silently corrupt every inline index — fail loudly instead
    # (ADVICE r3).
    if len(uend) and len(block_csizes):
        total_u = int(uend.max())
        nb = len(block_csizes)
        if not ((nb - 1) * P < total_u <= nb * P):
            raise ValueError(
                f"BGZF block layout violates the fixed-payload invariant: "
                f"{nb} blocks x {P} B payload cannot span the {total_u} B "
                "uncompressed stream — writer flush logic changed; "
                "write_bai_from_columns voffsets would be corrupt")
    bi = ustart // P  # every non-final payload block is exactly P bytes
    vbeg = (coff[bi] << 16) | (ustart - bi * P)
    be = np.maximum(uend - 1, 0) // P
    vend = (coff[be] << 16) | (uend - be * P)

    n_no_coor = int((rid < 0).sum())
    refs = [_RefIndex() for _ in range(n_ref)]
    placed = int(len(rid) - n_no_coor)  # sort puts rid<0 last
    bins_all = _reg2bin_vec(pos, np.maximum(end, pos + 1))

    # rid ascending over the placed prefix -> per-ref contiguous runs
    bounds = np.searchsorted(rid[:placed], np.arange(n_ref + 1))
    for r in range(n_ref):
        i0, i1 = int(bounds[r]), int(bounds[r + 1])
        if i1 <= i0:
            continue
        ref = refs[r]
        ref.off_beg = int(vbeg[i0])
        ref.off_end = int(vend[i1 - 1])
        m = mapped[i0:i1]
        ref.n_mapped = int(m.sum())
        ref.n_unmapped = int((~m).sum())
        vb, ve = vbeg[i0:i1], vend[i0:i1]
        bins = bins_all[i0:i1]
        pp, ee = pos[i0:i1], end[i0:i1]

        # ---- bins: stable sort by bin keeps ascending voffsets per bin;
        # merge consecutive chunks that share a compressed block.
        order = np.argsort(bins, kind="stable")
        b_s, vb_s, ve_s = bins[order], vb[order], ve[order]
        new_bin = np.empty(len(b_s), dtype=bool)
        new_bin[0] = True
        np.not_equal(b_s[1:], b_s[:-1], out=new_bin[1:])
        new_chunk = new_bin.copy()
        np.logical_or(new_chunk[1:], (vb_s[1:] >> 16) != (ve_s[:-1] >> 16),
                      out=new_chunk[1:])
        cidx = np.nonzero(new_chunk)[0]
        chunk_beg = vb_s[cidx]
        chunk_end = ve_s[np.concatenate([cidx[1:] - 1, [len(b_s) - 1]])]
        chunk_bin = b_s[cidx]
        first_of_bin = np.nonzero(new_bin[cidx])[0]
        bin_bounds = np.concatenate([first_of_bin, [len(cidx)]])
        for k in range(len(first_of_bin)):
            c0, c1 = int(bin_bounds[k]), int(bin_bounds[k + 1])
            ref.bins[int(chunk_bin[c0])] = [
                [int(chunk_beg[c]), int(chunk_end[c])] for c in range(c0, c1)
            ]

        # ---- linear index: first vbeg per 16 kb window spanned by each
        # record — voffsets ascend in file order, so "first write wins" ==
        # plain minimum (sentinel-initialized; 0 = empty in the format).
        w_beg = pp >> _LINEAR_SHIFT
        w_end = np.maximum(pp, ee - 1) >> _LINEAR_SHIFT
        sentinel = np.iinfo(np.int64).max
        lin = np.full(int(w_end.max()) + 1, sentinel, dtype=np.int64)
        d = 0
        alive = np.arange(len(pp))
        while len(alive):
            np.minimum.at(lin, w_beg[alive] + d, vb[alive])
            d += 1
            alive = alive[w_beg[alive] + d <= w_end[alive]]
        ref.linear = [0 if v == sentinel else int(v) for v in lin]

    return _finish_and_write_bai(refs, n_no_coor, os.fspath(bai_path))


def _finish_and_write_bai(refs: list[_RefIndex], n_no_coor: int,
                          bai_path: str) -> str:
    """Forward-fill linear indexes, serialize, atomically place the .bai."""
    for r in refs:
        # Forward-fill empty 16 kb windows with the previous window's offset
        # (htslib carries values forward in hts_idx_finish) so fetch's
        # linear floor never degrades to 0 when beg lands in a coverage gap.
        # Leading zeros (windows before the first record) stay 0.
        last = 0
        for i, v in enumerate(r.linear):
            if v == 0:
                r.linear[i] = last
            else:
                last = v

    tmp = bai_path + ".tmp"
    with open(tmp, "wb") as out:
        out.write(BAI_MAGIC)
        out.write(struct.pack("<i", len(refs)))
        for r in refs:
            has_meta = r.off_beg >= 0
            out.write(struct.pack("<i", len(r.bins) + (1 if has_meta else 0)))
            for b in sorted(r.bins):
                chunks = r.bins[b]
                out.write(struct.pack("<Ii", b, len(chunks)))
                for beg, end in chunks:
                    out.write(struct.pack("<QQ", beg, end))
            if has_meta:
                out.write(struct.pack("<Ii", _PSEUDO_BIN, 2))
                out.write(struct.pack("<QQ", r.off_beg, r.off_end))
                out.write(struct.pack("<QQ", r.n_mapped, r.n_unmapped))
            out.write(struct.pack("<i", len(r.linear)))
            for v in r.linear:
                out.write(struct.pack("<Q", v))
        out.write(struct.pack("<Q", n_no_coor))
    commit_file(tmp, bai_path)
    return bai_path


@dataclass
class BaiIndex:
    """Loaded .bai: per-ref bins/linear + metadata."""

    bins: list[dict[int, list[tuple[int, int]]]]
    linear: list[list[int]]
    meta: list[tuple[int, int, int, int] | None]  # (off_beg, off_end, mapped, unmapped)
    n_no_coor: int

    @classmethod
    def load(cls, path) -> "BaiIndex":
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != BAI_MAGIC:
            raise ValueError(f"not a BAI index: {os.fspath(path)!r}")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        bins, linear, meta = [], [], []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            ref_bins: dict[int, list[tuple[int, int]]] = {}
            ref_meta = None
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((beg, end))
                if b == _PSEUDO_BIN:
                    ref_meta = (chunks[0][0], chunks[0][1], chunks[1][0], chunks[1][1])
                else:
                    ref_bins[b] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ref_linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            bins.append(ref_bins)
            linear.append(ref_linear)
            meta.append(ref_meta)
        n_no_coor = struct.unpack_from("<Q", data, off)[0] if off + 8 <= len(data) else 0
        return cls(bins=bins, linear=linear, meta=meta, n_no_coor=n_no_coor)


class IndexedBamReader:
    """Random-access BAM reader over a .bai (``pysam.fetch`` parity).

    ``fetch(ref, beg, end)`` yields exactly the records overlapping
    ``[beg, end)`` on ``ref``, in file (coordinate) order, touching only the
    compressed blocks the index points at.  A missing ``.bai`` is built
    first (:func:`index_bam`).
    """

    def __init__(self, bam_path, bai_path=None):
        bam_path = os.fspath(bam_path)
        bai_path = bai_path or bam_path + ".bai"
        if not os.path.exists(bai_path):
            index_bam(bam_path, bai_path)
        self.index = BaiIndex.load(bai_path)
        # the header first (it pins the ref name -> id mapping); the raw
        # handle opens last, so a parse failure cannot leak it
        with BamReader(bam_path) as r:
            self.header: BamHeader = r.header
        self._fh = open(bam_path, "rb")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_from(self, voffset: int):
        """Yield the ``(vbeg, body)`` record stream from ``voffset`` on."""
        self._fh.seek(voffset >> 16)
        buf = bytearray()
        u = 0
        skip = voffset & 0xFFFF
        tracker = _VoffsetTracker()
        eof = False

        def fill(need: int) -> bool:
            nonlocal eof
            while len(buf) - skip < need and not eof:
                coffset = self._fh.tell()
                payload = bgzf.read_block(self._fh)
                if payload is None:
                    eof = True
                    break
                tracker.add_block(u + len(buf), coffset, len(payload))
                buf.extend(payload)
            return len(buf) - skip >= need

        if not fill(0) and not buf:
            return
        while True:
            if skip:  # drop the intra-block skip once; u keeps the anchors valid
                del buf[:skip]
                u += skip
                skip = 0
            if not fill(4):
                return
            vbeg = tracker.voffset(u)
            (block_size,) = struct.unpack_from("<i", buf, 0)
            if not fill(4 + block_size):
                raise ValueError("truncated BAM record")
            body = bytes(buf[4:4 + block_size])
            del buf[:4 + block_size]
            u += 4 + block_size
            yield vbeg, body

    def fetch(self, ref: str, beg: int = 0, end: int | None = None):
        """Yield the decoded records overlapping ``[beg, end)`` on ``ref``
        (``end`` None: to the reference's end)."""
        rid = self.header.ref_id(ref)
        if end is None:
            end = self.header.refs[rid][1]
        if end <= beg:
            return  # nothing overlaps an empty interval
        ref_bins = self.index.bins[rid]
        chunks: list[tuple[int, int]] = []
        for b in reg2bins(beg, end):
            chunks.extend(ref_bins.get(b, ()))
        if not chunks:
            return
        # the linear index's floor: skip chunks ending before the first
        # record that could overlap beg
        lin = self.index.linear[rid]
        w = beg >> _LINEAR_SHIFT
        min_off = lin[w] if w < len(lin) else (lin[-1] if lin else 0)
        chunks = sorted(c for c in chunks if c[1] > min_off)
        if not chunks:
            return
        merged = [list(chunks[0])]  # overlapping or adjacent runs read once
        for cb, ce in chunks[1:]:
            if cb <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], ce)
            else:
                merged.append([cb, ce])
        for cb, ce in merged:
            for vbeg, body in self._read_from(max(cb, min_off)):
                if vbeg >= ce:
                    break
                ref_id, pos, rec_end, _mapped = _record_span(body)
                if ref_id != rid or pos >= end:
                    break
                if rec_end > beg:
                    yield decode_record(body, self.header)
