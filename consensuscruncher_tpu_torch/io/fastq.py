"""FASTQ reader/writer (gzip-transparent).

Port of ``consensuscruncher_tpu/io/fastq.py``.  Reference parity: the
Biopython ``FastqGeneralIterator`` + ``gzip`` usage in
``ConsensusCruncher/extract_barcodes.py`` (SURVEY.md §2; the package
owns the parser instead of depending on Biopython).  Records are
``(name, seq, qual)`` string triples; ``name`` excludes the leading ``@``
and keeps any comment.
"""

from __future__ import annotations

import gzip
from typing import Iterator


def _open_text(path, mode: str):
    """Read-side opener (writing goes through :class:`FastqWriter`)."""
    p = str(path)
    if "w" in mode:
        raise ValueError("use FastqWriter for writing")
    if p.endswith(".gz"):
        return gzip.open(p, mode + "t", encoding="ascii")
    return open(p, mode, encoding="ascii")


def read_fastq(path) -> Iterator[tuple[str, str, str]]:
    """Yield ``(name, seq, qual)`` triples; validates 4-line framing."""
    with _open_text(path, "r") as fh:
        while True:
            head = fh.readline()
            if not head:
                return
            if not head.startswith("@"):
                raise ValueError(f"bad FASTQ header line: {head!r}")
            seq = fh.readline().rstrip("\r\n")
            plus = fh.readline()
            qual = fh.readline().rstrip("\r\n")
            if not plus.startswith("+"):
                raise ValueError(f"bad FASTQ separator for {head.strip()!r}")
            if len(seq) != len(qual):
                raise ValueError(f"seq/qual length mismatch for {head.strip()!r}")
            yield head[1:].rstrip("\r\n"), seq, qual


class FastqWriter:
    """Binary-mode writer (gzip-transparent, mtime=0 for deterministic .gz
    bytes); ``write`` takes string triples, ``write_bytes`` pre-assembled
    record blobs (the vectorized extract path) — identical output bytes."""

    def __init__(self, path, level: int = 6):
        # level 6 (the gzip/bgzip CLI default): python's GzipFile default of
        # 9 costs far more deflate time for ~1% size on FASTQ.  Goldens hash
        # decompressed content, so the level is a pure throughput knob.
        #
        # .gz outputs are written as BGZF: still a valid multi-member gzip
        # stream (gunzip/bwa/STAR all read it — bgzip's own trick), but the
        # deflate runs through the native batch codec and its thread pool
        # (io/bgzf.codec_threads), so extraction scales with host cores
        # instead of serializing one zlib stream on the Python thread.
        p = str(path)
        if p.endswith(".gz"):
            from consensuscruncher_tpu_torch.io import bgzf

            self._fh = bgzf.BgzfWriter(p, level=level)
        else:
            self._fh = open(p, "wb")

    def write(self, name: str, seq: str, qual: str) -> None:
        self._fh.write(f"@{name}\n{seq}\n+\n{qual}\n".encode("ascii"))

    def write_bytes(self, blob: bytes) -> None:
        self._fh.write(blob)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Columnar batch reader: the vectorized extract_barcodes path decodes whole
# chunks of records into a byte pool + offset columns (same design as
# io/columnar.py for BAM).  Framing is validated vectorized; '\r\n' line
# endings are handled by trimming a trailing '\r' per line.

import numpy as np


class FastqBatch:
    """One chunk of records over a shared byte pool ``data``.

    Per record (``(n,)`` int64 columns): ``name_start``/``name_len`` (the
    full header after '@', comment included), ``seq_start``/``seq_len``,
    ``qual_start`` (qual length == seq length, validated).
    """

    __slots__ = ("data", "name_start", "name_len", "seq_start", "seq_len",
                 "qual_start")

    def __init__(self, data, name_start, name_len, seq_start, seq_len, qual_start):
        self.data = data
        self.name_start = name_start
        self.name_len = name_len
        self.seq_start = seq_start
        self.seq_len = seq_len
        self.qual_start = qual_start

    @property
    def n(self) -> int:
        return len(self.name_start)


def _open_binary(path):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.GzipFile(p, "rb")
    return open(p, "rb")


def read_fastq_batches(path, chunk_bytes: int = 32 << 20):
    """Yield :class:`FastqBatch` chunks; same framing validation as
    :func:`read_fastq` (leading '@', '+' separator, equal seq/qual length)."""
    with _open_binary(path) as fh:
        tail = b""
        eof = False
        rec_base = 0  # absolute record number of the chunk's first record
        while not eof:
            chunk = fh.read(chunk_bytes)
            if not chunk:
                eof = True
            blob = tail + chunk
            if not blob:
                return
            if eof and not blob.endswith(b"\n"):
                blob += b"\n"  # files without a final newline parse like readline()
            buf = np.frombuffer(blob, np.uint8)
            nl = np.nonzero(buf == 10)[0]
            n_lines = len(nl)
            if eof and n_lines % 4:
                raise ValueError("FASTQ truncated: record is not 4 lines")
            n_rec = (n_lines // 4)
            if n_rec == 0:
                if eof and len(blob):
                    raise ValueError("FASTQ truncated: record is not 4 lines")
                tail = blob
                continue
            used = int(nl[4 * n_rec - 1]) + 1
            tail = blob[used:]
            nl = nl[: 4 * n_rec]
            starts = np.empty(4 * n_rec, np.int64)
            starts[0] = 0
            starts[1:] = nl[:-1] + 1
            ends = nl.copy()  # exclusive of '\n'
            # trim '\r' of CRLF files
            has_cr = ends > starts
            cr = np.zeros(4 * n_rec, bool)
            cr[has_cr] = buf[ends[has_cr] - 1] == 13
            ends = ends - cr
            l0, l1, l2, l3 = (starts[k::4] for k in range(4))
            e0, e1, e2, e3 = (ends[k::4] for k in range(4))
            if not (buf[l0] == ord("@")).all():
                bad = int(np.nonzero(buf[l0] != ord("@"))[0][0])
                raise ValueError(
                    f"bad FASTQ header line at record {rec_base + bad}: "
                    f"{bytes(buf[l0[bad]:e0[bad]])[:40]!r}"
                )
            if not ((e2 > l2) & (buf[np.minimum(l2, len(buf) - 1)] == ord("+"))).all():
                raise ValueError("bad FASTQ separator line (expected '+')")
            seq_len = e1 - l1
            if not (seq_len == (e3 - l3)).all():
                bad = int(np.nonzero(seq_len != (e3 - l3))[0][0])
                raise ValueError(
                    f"seq/qual length mismatch at record "
                    f"{bytes(buf[l0[bad] + 1:e0[bad]])[:40]!r}"
                )
            yield FastqBatch(
                data=buf,
                name_start=l0 + 1, name_len=e0 - (l0 + 1),
                seq_start=l1, seq_len=seq_len,
                qual_start=l3,
            )
            rec_base += n_rec
        if tail:
            raise ValueError("FASTQ truncated: record is not 4 lines")
