"""A small BAM writer and reader of the benchmark's own (numpy and zlib).

The benchmark writes its inputs and reads the program's outputs with this
module, so that neither side of the comparison depends on the program's
BAM code.  It covers what the benchmark needs: one reference sequence,
records of one read length and a plain ``<L>M`` cigar on the write side;
any record on the read side (each record's fields, its cigar words and
its tag block as raw bytes).  BGZF blocks are deflated on a thread pool
(zlib releases the interpreter lock while it compresses).
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BLOCK_PAYLOAD = 0xFF00  # uncompressed bytes per BGZF block, as htslib writes them
EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
SEQ_NIBBLE = np.array([1, 2, 4, 8, 15], np.uint8)  # A C G T N in BAM's 4-bit code
NIBBLE_CODE = np.full(16, 4, np.uint8)
NIBBLE_CODE[[1, 2, 4, 8]] = [0, 1, 2, 3]


def _bgzf_block(payload: bytes, level: int) -> bytes:
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    data = comp.compress(payload) + comp.flush()
    head = struct.pack("<4BI2BH2BHH", 31, 139, 8, 4, 0, 0, 255, 6, 66, 67, 2,
                       len(data) + 25)
    return head + data + struct.pack("<II", zlib.crc32(payload), len(payload))


def bgzf_compress(raw: bytes, level: int = 6, threads: int = 8) -> bytes:
    """``raw`` as BGZF blocks, the EOF block last."""
    chunks = [raw[i:i + BLOCK_PAYLOAD] for i in range(0, len(raw), BLOCK_PAYLOAD)]
    with ThreadPoolExecutor(threads) as pool:
        blocks = list(pool.map(lambda c: _bgzf_block(c, level), chunks))
    return b"".join(blocks) + EOF_BLOCK


def bgzf_decompress(data: bytes) -> bytes:
    """The payload of a BGZF file, its blocks' CRCs checked."""
    out = []
    off = 0
    n = len(data)
    while off < n:
        if data[off:off + 4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"not a BGZF block at byte {off}")
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        bsize = None
        x = off + 12
        while x < off + 12 + xlen:
            si1, si2, slen = struct.unpack_from("<BBH", data, x)
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", data, x + 4)[0]
            x += 4 + slen
        if bsize is None:
            raise ValueError(f"BGZF block at byte {off} has no BSIZE")
        end = off + bsize + 1
        payload = zlib.decompress(data[off + 12 + xlen:end - 8], -15)
        crc, isize = struct.unpack_from("<II", data, end - 8)
        if isize != len(payload) or crc != zlib.crc32(payload):
            raise ValueError(f"BGZF block at byte {off} fails its CRC or size")
        out.append(payload)
        off = end
    return b"".join(out)


def header_bytes(ref_name: str, ref_len: int) -> bytes:
    text = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{ref_name}\tLN:{ref_len}\n".encode()
    name = ref_name.encode() + b"\x00"
    return (b"BAM\x01" + struct.pack("<i", len(text)) + text + struct.pack("<i", 1)
            + struct.pack("<i", len(name)) + name + struct.pack("<i", ref_len))


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The SAM specification's bin of ``[beg, end)``, vectorised."""
    end = end - 1
    out = np.zeros(beg.shape, np.int64)
    done = np.zeros(beg.shape, bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def encode_records(qnames: np.ndarray, flag, pos, mapq, mate_pos, tlen,
                   codes: np.ndarray, quals: np.ndarray) -> bytes:
    """Records on reference 0 with no tags: ``qnames`` a ``(n, W)`` uint8
    matrix (every name ``W`` bytes long), ``codes`` and ``quals`` ``(n, L)``
    uint8 (codes 0-4 = A C G T N), one ``<L>M`` cigar each."""
    n, width = qnames.shape
    length = codes.shape[1]
    seq_bytes = (length + 1) // 2
    dtype = np.dtype([
        ("block_size", "<i4"), ("ref", "<i4"), ("pos", "<i4"), ("l_qname", "u1"),
        ("mapq", "u1"), ("bin", "<u2"), ("n_cigar", "<u2"), ("flag", "<u2"),
        ("l_seq", "<i4"), ("mate_ref", "<i4"), ("mate_pos", "<i4"), ("tlen", "<i4"),
        ("qname", "u1", (width + 1,)), ("cigar", "<u4"), ("seq", "u1", (seq_bytes,)),
        ("qual", "u1", (length,)),
    ])
    rec = np.zeros(n, dtype)
    rec["block_size"] = dtype.itemsize - 4
    rec["pos"] = pos
    rec["l_qname"] = width + 1
    rec["mapq"] = mapq
    rec["bin"] = reg2bin(np.asarray(pos, np.int64), np.asarray(pos, np.int64) + length)
    rec["n_cigar"] = 1
    rec["flag"] = flag
    rec["l_seq"] = length
    rec["mate_pos"] = mate_pos
    rec["tlen"] = tlen
    rec["qname"][:, :width] = qnames
    rec["cigar"] = length << 4
    nib = SEQ_NIBBLE[codes]
    if length % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    rec["seq"] = (nib[:, 0::2] << 4) | nib[:, 1::2]
    rec["qual"] = quals
    return rec.tobytes()


def write_bam(path: str, ref_name: str, ref_len: int, records: bytes, level: int = 6,
              threads: int = 8) -> int:
    """Write a coordinate-sorted BAM (no index); returns the bytes written."""
    data = bgzf_compress(header_bytes(ref_name, ref_len) + records, level, threads)
    with open(path, "wb") as fh:
        fh.write(data)
    return len(data)


class Records:
    """The records of a BAM, column by column (numpy arrays over the
    decompressed payload ``buf``)."""

    def __init__(self, buf: bytes, offsets: np.ndarray):
        self.buf = np.frombuffer(buf, np.uint8)
        self.off = offsets                      # each record's block_size field
        n = len(offsets)
        self.n = n

        def field(at, dtype):
            size = np.dtype(dtype).itemsize
            idx = (offsets + at)[:, None] + np.arange(size)
            return self.buf[idx].copy().view(dtype).reshape(n)

        self.block_size = field(0, "<i4")
        self.ref = field(4, "<i4")
        self.pos = field(8, "<i4")
        self.l_qname = field(12, "u1").astype(np.int64)
        self.mapq = field(13, "u1")
        self.n_cigar = field(16, "<u2").astype(np.int64)
        self.flag = field(18, "<u2")
        self.l_seq = field(20, "<i4").astype(np.int64)
        self.mate_ref = field(24, "<i4")
        self.mate_pos = field(28, "<i4")
        self.tlen = field(32, "<i4")
        self.qname_at = offsets + 36
        self.cigar_at = self.qname_at + self.l_qname
        self.seq_at = self.cigar_at + 4 * self.n_cigar
        self.qual_at = self.seq_at + (self.l_seq + 1) // 2
        self.tags_at = self.qual_at + self.l_seq
        self.end = offsets + 4 + self.block_size

    def ragged(self, starts: np.ndarray, lens: np.ndarray) -> list[bytes]:
        raw = self.buf
        return [raw[s:s + k].tobytes() for s, k in zip(starts.tolist(), lens.tolist())]

    def qnames(self) -> list[bytes]:
        return self.ragged(self.qname_at, self.l_qname - 1)

    def cigars(self) -> list[bytes]:
        return self.ragged(self.cigar_at, 4 * self.n_cigar)

    def tags(self) -> list[bytes]:
        return self.ragged(self.tags_at, self.end - self.tags_at)

    def codes_quals(self, length: int) -> tuple[np.ndarray, np.ndarray]:
        """``(n, length)`` base codes (0-4) and quals of records that are all
        ``length`` long."""
        if self.n and not (self.l_seq == length).all():
            raise ValueError(f"records of other lengths than {length}")
        half = (length + 1) // 2
        packed = self.buf[self.seq_at[:, None] + np.arange(half)]
        nib = np.empty((self.n, 2 * half), np.uint8)
        nib[:, 0::2] = packed >> 4
        nib[:, 1::2] = packed & 15
        codes = NIBBLE_CODE[nib[:, :length]]
        quals = self.buf[self.qual_at[:, None] + np.arange(length)]
        return codes, quals


def read_bam(path: str) -> Records:
    """Every record of a BAM file."""
    with open(path, "rb") as fh:
        raw = bgzf_decompress(fh.read())
    if raw[:4] != b"BAM\x01":
        raise ValueError(f"{path} is not a BAM file")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    at = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, at)[0]
    at += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", raw, at)[0]
        at += 8 + l_name
    offsets = []
    unpack = struct.Struct("<i").unpack_from
    end = len(raw)
    while at < end:
        offsets.append(at)
        at += 4 + unpack(raw, at)[0]
    if at != end:
        raise ValueError(f"{path}: the last record runs past the end")
    return Records(raw, np.asarray(offsets, np.int64))
