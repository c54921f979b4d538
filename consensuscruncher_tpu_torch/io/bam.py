"""First-party BAM reader/writer (binary alignment format, SAM spec §4).

Replaces the pysam/htslib layer the reference leans on (SURVEY.md §2 "Native
components" — this environment has none, so the framework owns the format).
Pure-Python struct codec; the BGZF framing underneath can be served by the
native C++ codec in ``io/native`` when built.

Supported surface (everything the pipeline needs):
- full header (SAM text + reference dictionary) round-trip,
- all record fields: flags, cigar, 4-bit packed seq, qual, mate info, tlen,
- optional tags: A c C s S i I f Z H B (arrays),
- streaming read, streaming write, in-memory/spilled coordinate sort, merge.

Random access lives next door in ``io/bai.py`` (spec BAI build + region
``fetch``), used for ``samtools index`` parity on outputs.  The pipeline
stages themselves stream coordinate-sorted inputs start-to-finish — a
deliberate design difference from the reference's per-chromosome
``pysam.fetch`` loop; the streaming path needs no index files at all.
"""

from __future__ import annotations

import heapq
import os
import struct
import sys
import tempfile
from dataclasses import dataclass, field

import numpy as np

from consensuscruncher_tpu_torch.io import bgzf

BAM_MAGIC = b"BAM\x01"

# 4-bit seq nibble alphabet (SAM spec) and cigar op order.
SEQ_NIBBLES = "=ACMGRSVTWYHKDBN"
_NIB_OF = {c: i for i, c in enumerate(SEQ_NIBBLES)}
CIGAR_OPS = "MIDNSHP=X"
_CIGAR_OP_OF = {c: i for i, c in enumerate(CIGAR_OPS)}

# flag bits
FPAIRED = 0x1
FPROPER = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800


@dataclass
class BamHeader:
    """SAM header text + reference dictionary."""

    text: str = ""
    refs: list[tuple[str, int]] = field(default_factory=list)

    def __post_init__(self):
        self._ref_ids = {name: i for i, (name, _len) in enumerate(self.refs)}

    def ref_id(self, name: str) -> int:
        if name == "*" or name is None:
            return -1
        return self._ref_ids[name]

    def ref_name(self, rid: int) -> str:
        return "*" if rid < 0 else self.refs[rid][0]

    @classmethod
    def from_refs(cls, refs: list[tuple[str, int]], extra_text: str = "") -> "BamHeader":
        text = "@HD\tVN:1.6\tSO:unsorted\n"
        for name, length in refs:
            text += f"@SQ\tSN:{name}\tLN:{length}\n"
        return cls(text=text + extra_text, refs=list(refs))


@dataclass(eq=False)
class BamRead:
    """One alignment record; mutable, cheap, and duck-compatible with core.tags.

    ``seq`` is an ASCII string; ``qual`` a uint8 Phred array (len == len(seq),
    or size 0 for '*').  ``cigar`` is a list of ``(op_char, length)``.
    ``ref``/``mate_ref`` are reference *names* ("*" when unmapped), resolved
    against the header at codec boundaries.
    """

    qname: str
    flag: int = 0
    ref: str = "*"
    pos: int = -1
    mapq: int = 0
    cigar: list[tuple[str, int]] = field(default_factory=list)
    mate_ref: str = "*"
    mate_pos: int = -1
    tlen: int = 0
    seq: str = ""
    qual: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.uint8))
    tags: dict[str, tuple[str, object]] = field(default_factory=dict)

    @property
    def seq_len(self) -> int:
        """Uniform length accessor shared with the columnar MemberView."""
        return len(self.seq)

    @property
    def codes(self) -> np.ndarray:
        """Pipeline base codes (A=0..N=4) — MemberView-uniform accessor."""
        from consensuscruncher_tpu_torch.utils.phred import encode_seq

        return encode_seq(self.seq)

    def materialize(self) -> "BamRead":
        """MemberView-uniform accessor: a BamRead already is materialized."""
        return self

    # -- flag properties (pysam-compatible names where it matters) --
    @property
    def is_paired(self) -> bool:
        return bool(self.flag & FPAIRED)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def mate_is_unmapped(self) -> bool:
        return bool(self.flag & FMUNMAP)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def mate_is_reverse(self) -> bool:
        return bool(self.flag & FMREVERSE)

    @property
    def is_read1(self) -> bool:
        return bool(self.flag & FREAD1)

    @property
    def is_read2(self) -> bool:
        return bool(self.flag & FREAD2)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FSECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FSUPPLEMENTARY)

    @property
    def is_qcfail(self) -> bool:
        return bool(self.flag & FQCFAIL)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & FDUP)

    def cigar_string(self) -> str:
        return "*" if not self.cigar else "".join(f"{n}{op}" for op, n in self.cigar)

    def __eq__(self, other) -> bool:
        if not isinstance(other, BamRead):
            return NotImplemented
        return (
            self.qname == other.qname
            and self.flag == other.flag
            and self.ref == other.ref
            and self.pos == other.pos
            and self.mapq == other.mapq
            and self.cigar == other.cigar
            and self.mate_ref == other.mate_ref
            and self.mate_pos == other.mate_pos
            and self.tlen == other.tlen
            and self.seq == other.seq
            and np.array_equal(self.qual, other.qual)
            and self.tags == other.tags
        )


def cigar_from_string(s: str) -> list[tuple[str, int]]:
    if s in ("*", ""):
        return []
    out, num = [], ""
    for ch in s:
        if ch.isdigit():
            num += ch
        else:
            out.append((ch, int(num)))
            num = ""
    return out


# ---------------------------------------------------------------- record codec

_CORE = struct.Struct("<iiBBHHHiiii")  # refID..tlen after block_size


def _encode_tags(tags: dict[str, tuple[str, object]]) -> bytes:
    out = bytearray()
    for key, (typ, val) in tags.items():
        out += key.encode("ascii")
        if typ == "A":
            out += b"A" + str(val)[0].encode("ascii")
        elif typ in "cCsSiI":
            out += typ.encode("ascii") + struct.pack("<" + {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I"}[typ], int(val))
        elif typ == "f":
            out += b"f" + struct.pack("<f", float(val))
        elif typ in ("Z", "H"):
            out += typ.encode("ascii") + str(val).encode("ascii") + b"\x00"
        elif typ == "B":
            sub, arr = val
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            out += b"B" + sub.encode("ascii") + struct.pack("<I", len(arr))
            out += struct.pack(f"<{len(arr)}{fmt}", *arr)
        else:
            raise ValueError(f"unsupported tag type {typ!r} for {key}")
    return bytes(out)


def _decode_tags(buf: bytes) -> dict[str, tuple[str, object]]:
    tags: dict[str, tuple[str, object]] = {}
    off, end = 0, len(buf)
    while off < end:
        key = buf[off : off + 2].decode("ascii")
        typ = chr(buf[off + 2])
        off += 3
        if typ == "A":
            tags[key] = ("A", chr(buf[off])); off += 1
        elif typ in "cCsSiI":
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I"}[typ]
            (v,) = struct.unpack_from("<" + fmt, buf, off)
            tags[key] = (typ, v); off += struct.calcsize(fmt)
        elif typ == "f":
            (v,) = struct.unpack_from("<f", buf, off)
            tags[key] = ("f", v); off += 4
        elif typ in ("Z", "H"):
            z = buf.index(b"\x00", off)
            tags[key] = (typ, buf[off:z].decode("ascii")); off = z + 1
        elif typ == "B":
            sub = chr(buf[off]); (n,) = struct.unpack_from("<I", buf, off + 1)
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            vals = list(struct.unpack_from(f"<{n}{fmt}", buf, off + 5))
            tags[key] = ("B", (sub, vals)); off += 5 + n * struct.calcsize(fmt)
        else:
            raise ValueError(f"unsupported tag type {typ!r} in record")
    return tags


# Unknown characters map to N (nibble 15), matching htslib — never silently
# to '=' (nibble 0), which would corrupt the sequence.
_NIB_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _i in _NIB_OF.items():
    _NIB_LUT[ord(_c)] = _i
    _NIB_LUT[ord(_c.lower())] = _i
_NIB_CHARS = np.frombuffer(SEQ_NIBBLES.encode(), dtype=np.uint8)


def _pack_seq(seq: str) -> bytes:
    codes = _NIB_LUT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
    if len(codes) % 2:
        codes = np.append(codes, 0)
    return ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()


def _unpack_seq(buf: bytes, l_seq: int) -> str:
    arr = np.frombuffer(buf, dtype=np.uint8)
    nibs = np.empty(arr.size * 2, dtype=np.uint8)
    nibs[0::2] = arr >> 4
    nibs[1::2] = arr & 0xF
    return _NIB_CHARS[nibs[:l_seq]].tobytes().decode("ascii")


def encode_record(read: BamRead, header: BamHeader) -> bytes:
    name = read.qname.encode("ascii") + b"\x00"
    l_seq = len(read.seq)
    cigar = b"".join(struct.pack("<I", (n << 4) | _CIGAR_OP_OF[op]) for op, n in read.cigar)
    seq = _pack_seq(read.seq) if l_seq else b""
    if read.qual.size:
        if read.qual.size != l_seq:
            raise ValueError(f"qual length {read.qual.size} != seq length {l_seq} for {read.qname}")
        qual = read.qual.astype(np.uint8).tobytes()
    else:
        qual = b"\xff" * l_seq
    tags = _encode_tags(read.tags)
    # reg2bin of the unclipped interval; 0 is acceptable (only indexers care),
    # but compute the spec value so htslib round-trips byte-identically.
    end = read.pos + max(1, sum(n for op, n in read.cigar if op in "MDN=X"))
    body = _CORE.pack(
        header.ref_id(read.ref),
        read.pos,
        len(name),
        read.mapq,
        _reg2bin(read.pos, end) if read.pos >= 0 else 4680,
        len(read.cigar),
        read.flag,
        l_seq,
        header.ref_id(read.mate_ref),
        read.mate_pos,
        read.tlen,
    ) + name + cigar + seq + qual + tags
    return struct.pack("<i", len(body)) + body


def decode_record(body: bytes, header: BamHeader) -> BamRead:
    (rid, pos, l_name, mapq, _bin, n_cigar, flag, l_seq, mrid, mpos, tlen) = _CORE.unpack_from(body, 0)
    off = _CORE.size
    qname = body[off : off + l_name - 1].decode("ascii")
    off += l_name
    cigar = []
    for _ in range(n_cigar):
        (v,) = struct.unpack_from("<I", body, off)
        cigar.append((CIGAR_OPS[v & 0xF], v >> 4))
        off += 4
    n_seq_bytes = (l_seq + 1) // 2
    seq = _unpack_seq(body[off : off + n_seq_bytes], l_seq)
    off += n_seq_bytes
    qual_raw = np.frombuffer(body[off : off + l_seq], dtype=np.uint8).copy()
    if l_seq and qual_raw.size and qual_raw[0] == 0xFF:
        qual_raw = np.zeros(0, dtype=np.uint8)
    off += l_seq
    return BamRead(
        qname=qname,
        flag=flag,
        ref=header.ref_name(rid),
        pos=pos,
        mapq=mapq,
        cigar=cigar,
        mate_ref=header.ref_name(mrid),
        mate_pos=mpos,
        tlen=tlen,
        seq=seq,
        qual=qual_raw,
        tags=_decode_tags(body[off:]),
    )


def _reg2bin(beg: int, end: int) -> int:
    """SAM spec reg2bin (UCSC binning) — stored per record for indexer parity."""
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


# ---------------------------------------------------------------- file objects

def read_bam_header(bgzf_reader) -> BamHeader:
    """Parse the BAM magic + header block from an open BGZF stream, leaving
    it positioned at the first alignment record (shared by the object and
    columnar readers so header handling cannot diverge between them)."""
    magic = bgzf_reader.read(4)
    if magic != BAM_MAGIC:
        raise ValueError(f"not a BAM file: magic {magic!r}")
    (l_text,) = struct.unpack("<i", bgzf_reader.read(4))
    text = bgzf_reader.read(l_text).decode("ascii", errors="replace").rstrip("\x00")
    (n_ref,) = struct.unpack("<i", bgzf_reader.read(4))
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", bgzf_reader.read(4))
        name = bgzf_reader.read(l_name)[:-1].decode("ascii")
        (l_ref,) = struct.unpack("<i", bgzf_reader.read(4))
        refs.append((name, l_ref))
    return BamHeader(text=text, refs=refs)


class BamReader:
    """Streaming BAM reader: ``for read in BamReader(path): ...``

    ``salvage=True``: recover what a truncated file still holds — the BGZF
    layer stops at the last intact block and this layer stops at the last
    complete record inside it, warning instead of raising.  The header must
    still be intact (nothing is recoverable without it).
    """

    def __init__(self, path, salvage: bool = False):
        self._bgzf = bgzf.BgzfReader(path, salvage=salvage)
        self._salvage = salvage
        self.header = read_bam_header(self._bgzf)

    def __iter__(self):
        while True:
            raw = self._bgzf.read(4)
            if len(raw) == 0:
                return
            if len(raw) < 4:
                # A partial length prefix is never valid — a file truncated at
                # a BGZF block boundary must not read as a complete dataset.
                if self._salvage:
                    print("WARNING: truncated BAM record (partial length "
                          "prefix); stopping at last complete record",
                          file=sys.stderr, flush=True)
                    return
                raise ValueError("truncated BAM record (partial length prefix)")
            (block_size,) = struct.unpack("<i", raw)
            body = self._bgzf.read(block_size)
            if len(body) < block_size:
                if self._salvage:
                    print("WARNING: truncated BAM record; stopping at last "
                          "complete record", file=sys.stderr, flush=True)
                    return
                raise ValueError("truncated BAM record")
            yield decode_record(body, self.header)

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamWriter:
    """Streaming BAM writer; atomic if given a final path via ``atomic=True``."""

    def __init__(self, path, header: BamHeader, level: int = 6, atomic: bool = False):
        self._final_path = os.fspath(path) if atomic else None
        self._path = self._final_path + ".tmp" if atomic else path
        self._bgzf = bgzf.BgzfWriter(self._path, level=level)
        self.header = header
        text = header.text.encode("ascii")
        out = bytearray(BAM_MAGIC)
        out += struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(header.refs))
        for name, length in header.refs:
            bname = name.encode("ascii") + b"\x00"
            out += struct.pack("<i", len(bname)) + bname + struct.pack("<i", length)
        self._bgzf.write(bytes(out))

    def write(self, read: BamRead) -> None:
        self._bgzf.write(encode_record(read, self.header))

    def write_encoded(self, blob) -> None:
        """Append pre-encoded, length-prefixed record bytes (the vectorized
        ``io.encode.encode_records`` output) verbatim."""
        self._bgzf.write(blob.tobytes() if isinstance(blob, np.ndarray) else blob)

    def close(self) -> None:
        self._bgzf.close()
        if self._final_path is not None:
            # Durable commit (fsync + rename + dir fsync): a committed stage
            # output must never fingerprint as complete while partially on
            # disk — --resume trusts what it finds here.
            from consensuscruncher_tpu_torch.utils.manifest import commit_file

            commit_file(self._path, self._final_path)

    def abort(self) -> None:
        """Discard the output: for atomic writers the final path is never
        touched; for plain writers the partial file is left (caller's path)."""
        self._bgzf.close()
        if self._final_path is not None and os.path.exists(self._path):
            os.unlink(self._path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # Never promote a partial atomic output over the final path when the
        # with-body raised — that would publish a truncated-but-valid BAM.
        if exc_type is not None:
            self.abort()
        else:
            self.close()


# ---------------------------------------------------------------- sort / merge

def _coord_key(read: BamRead, header: BamHeader):
    rid = header.ref_id(read.ref)
    return (rid if rid >= 0 else 1 << 30, read.pos, read.qname, read.flag)


# Compressed-size ceiling for the in-memory columnar sort (~4x expansion
# plus one gathered copy); larger inputs take the spill/merge object path.
_COLUMNAR_SORT_MAX_BYTES = int(os.environ.get("CCT_COLUMNAR_SORT_MAX_BYTES", 96 << 20))


def sort_bam(in_path, out_path, max_in_memory: int = 2_000_000, level: int = 6) -> None:
    """Coordinate sort (samtools-sort parity). External-sorts via sorted
    temp chunks + a columnar k-way merge when the input exceeds the
    in-memory bounds.

    Inputs whose compressed size fits ``CCT_COLUMNAR_SORT_MAX_BYTES`` take
    the columnar fast path (``io.columnar.sort_bam_columnar``): identical
    total order, but a pure byte shuffle — records are never decoded.  The
    external path is columnar too (chunks sort as byte shuffles, the merge
    is ``io.columnar.merge_sorted_columnar``); the object heap merge
    survives only as the last-resort fallback when even the merge's key
    columns exceed the memory budget."""
    if os.path.getsize(in_path) <= _COLUMNAR_SORT_MAX_BYTES:
        from consensuscruncher_tpu_torch.io.columnar import sort_bam_columnar

        if sort_bam_columnar(in_path, out_path, level=level, max_records=max_in_memory):
            return
    from consensuscruncher_tpu_torch.io.columnar import (
        ColumnarReader,
        SortingBamWriter,
        merge_sorted_columnar,
    )

    reader = ColumnarReader(in_path)
    header = reader.header
    chunks: list[str] = []
    # chunk budget: a fraction of the sort buffer so several chunks' key
    # columns + one chunk's raw bytes coexist comfortably
    from consensuscruncher_tpu_torch.io.columnar import _default_sort_buffer_bytes

    chunk_budget = max(256 << 20, _default_sort_buffer_bytes() // 4)

    def new_chunk_writer() -> SortingBamWriter:
        fd, path = tempfile.mkstemp(suffix=".bam", prefix="ccsort.")
        os.close(fd)
        chunks.append(path)  # registered BEFORE use so cleanup always sees it
        # level 1 + no index: throwaway chunks, read back once
        return SortingBamWriter(path, header, level=1, index=False,
                                max_raw_bytes=chunk_budget * 2)

    def spill(blobs) -> None:
        w = new_chunk_writer()
        try:
            for p in blobs:
                w.write_encoded(p)
        except BaseException:
            w.abort()
            raise
        w.close()

    try:
        pending: list = []  # raw blobs of the chunk being accumulated
        raw = n = 0
        for b in reader.batches():
            blob = b.buf[: int(b.rec_off[-1])]
            pending.append(blob)
            raw += blob.size
            n += b.n
            if raw > chunk_budget or n > max_in_memory:
                spill(pending)
                pending, raw, n = [], 0, 0
        if not chunks:
            # everything fit one buffer: sort + write the output directly
            # (no temp round trip, inline index)
            final = SortingBamWriter(os.fspath(out_path), header, level=level)
            try:
                for p in pending:
                    final.write_encoded(p)
            except BaseException:
                final.abort()
                raise
            final.close()
            return
        if pending:
            spill(pending)
            pending = []
        # our own chunks are full-key-sorted by construction -> skip verify
        if not merge_sorted_columnar(chunks, out_path, header, level=level,
                                     verify_sorted=False):
            _merge_paths(chunks, out_path, header, level=level)
            from consensuscruncher_tpu_torch.io.bai import index_bam

            index_bam(out_path)  # parity with the columnar merge's inline .bai
    finally:
        reader.close()
        for c in chunks:
            if os.path.exists(c):
                os.unlink(c)


def _sorted_header(header: BamHeader) -> BamHeader:
    """Rewrite (only) the @HD line to declare SO:coordinate."""
    lines = header.text.splitlines(keepends=True)
    for i, line in enumerate(lines):
        if line.startswith("@HD"):
            fields = line.rstrip("\n").split("\t")
            fields = [f for f in fields if not f.startswith("SO:")] + ["SO:coordinate"]
            lines[i] = "\t".join(fields) + "\n"
            break
    else:
        lines.insert(0, "@HD\tVN:1.6\tSO:coordinate\n")
    return BamHeader(text="".join(lines), refs=header.refs)


def _merge_paths(paths: list[str], out_path, header: BamHeader, level: int = 6) -> None:
    readers = [BamReader(p) for p in paths]
    streams = [iter(r) for r in readers]
    heap = []
    for si, stream in enumerate(streams):
        read = next(stream, None)
        if read is not None:
            heap.append((_coord_key(read, header), si, read))
    heapq.heapify(heap)
    with BamWriter(out_path, _sorted_header(header), level=level, atomic=True) as w:
        while heap:
            _key, si, read = heapq.heappop(heap)
            w.write(read)
            nxt = next(streams[si], None)
            if nxt is not None:
                heapq.heappush(heap, (_coord_key(nxt, header), si, nxt))
    for r in readers:
        r.close()


def _merge_large(in_paths: list, out_path, header: BamHeader, level: int,
                 index: bool) -> None:
    """Beyond-buffer merge: columnar k-way shuffle, heap-merge fallback."""
    from consensuscruncher_tpu_torch.io.columnar import merge_sorted_columnar

    paths = [os.fspath(p) for p in in_paths]
    if not merge_sorted_columnar(paths, out_path, header, level=level,
                                 index=index):
        _merge_paths(paths, out_path, header, level=level)
        if index:  # parity with the columnar merge's inline .bai
            from consensuscruncher_tpu_torch.io.bai import index_bam

            index_bam(out_path)


def merge_bams(in_paths: list, out_path, level: int = 6, index: bool = True) -> None:
    """samtools-merge parity: merge coordinate-sorted inputs (headers must
    share a reference dictionary).

    Inputs that plausibly fit the in-memory sort buffer stream through a
    ``SortingBamWriter`` as raw blobs (one lexsort + one BGZF write — the
    k-way order over already-sorted inputs is a special case of the full
    coordinate sort, and the writer's key + stable-tie order match the
    object heap merge's exactly).  Larger inputs keep the O(k)-memory
    streaming heap merge — buffering them only to re-sort already-sorted
    data would double the I/O.

    ``level``: BGZF deflate level of the output — pass 0 (stored) or 1 for
    pipeline-internal merges whose content lives on in later outputs (the
    deflate is most of a merge's cost; VERDICT r2 weak #4)."""
    headers = []
    for p in in_paths:
        r = BamReader(p)
        headers.append(r.header)
        r.close()
    for p, h in zip(in_paths[1:], headers[1:]):
        if h.refs != headers[0].refs:
            raise ValueError(
                f"merge_bams: reference dictionary of {os.fspath(p)!r} differs from "
                f"{os.fspath(in_paths[0])!r} — inputs must share @SQ lines"
            )
    from consensuscruncher_tpu_torch.io.columnar import ColumnarReader, SortingBamWriter

    # Bound on ACTUAL raw bytes while reading (compressed size is no proxy —
    # low-complexity reads expand 10-30x); past the writer's buffer the
    # in-memory path would spill-and-resort already-sorted data, so switch
    # to the O(k)-memory streaming heap merge instead.
    writer = SortingBamWriter(os.fspath(out_path), headers[0], level=level,
                              index=index)
    # cheap precheck: genomic BAMs virtually never expand (BGZF framing can
    # exceed raw size only for incompressible records), so compressed-total >
    # buffer means the in-memory path would all but certainly spill —
    # skip straight to the streaming merge; the in-loop raw-bytes bound
    # below remains the authoritative guard either way
    if sum(os.path.getsize(os.fspath(p)) for p in in_paths) > writer._max_raw:
        writer.abort()
        _merge_large(in_paths, out_path, headers[0], level, index)
        return
    raw = 0
    try:
        for p in in_paths:
            with ColumnarReader(p) as reader:
                for b in reader.batches():
                    blob = b.buf[: int(b.rec_off[-1])]
                    raw += blob.size
                    if raw > writer._max_raw:
                        writer.abort()
                        _merge_large(in_paths, out_path, headers[0], level, index)
                        return
                    writer.write_encoded(blob)
    except BaseException:
        writer.abort()
        raise
    writer.close()


def merge_memory_bams(parts: list, out_path=None, level: int = 6,
                      index: bool = True):
    """:func:`merge_bams`' in-memory twin for the streaming pipeline.

    ``parts`` are :class:`~consensuscruncher_tpu_torch.io.columnar.MemoryBam`
    objects; empty ones contribute no records, exactly like a file-based
    merge of header-only BAMs.  The merge streams each
    part's sorted record blobs *in input order* through a fresh
    ``SortingBamWriter`` — the identical construction ``merge_bams`` uses
    on its in-memory path, so output bytes match file-based merges of the
    materialized parts byte for byte.

    ``out_path`` set: write the merged BAM (atomic, inline ``.bai`` when
    ``index``) and return None.  ``out_path`` None: return the merged
    ``MemoryBam`` via ``close_to_memory``.  Raises
    ``core.streamgraph.StreamFallback`` when the combined parts exceed the
    writer's in-memory budget (the CLI falls back to the staged pipeline
    rather than spill-resorting sorted data).
    """
    from consensuscruncher_tpu_torch.core.streamgraph import StreamFallback
    from consensuscruncher_tpu_torch.io.columnar import SortingBamWriter

    parts = list(parts)
    if not parts:
        raise ValueError("merge_memory_bams: no inputs")
    for m in parts[1:]:
        if m.header.refs != parts[0].header.refs:
            raise ValueError(
                "merge_memory_bams: inputs must share a reference dictionary")
    writer = SortingBamWriter(
        os.fspath(out_path) if out_path is not None else "<memory>",
        parts[0].header, level=level, index=index)
    if sum(m.nbytes for m in parts) > writer._max_raw:
        writer.abort()
        raise StreamFallback(
            "merge_memory_bams: inputs exceed the in-memory sort budget")
    try:
        for m in parts:
            for blob in m.record_blobs():
                writer.write_encoded(blob)
        if out_path is None:
            return writer.close_to_memory()
        writer.close()
        return None
    except BaseException:
        writer.abort()
        raise
