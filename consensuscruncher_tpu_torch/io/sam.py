"""SAM text codec — parse/format alignment lines to/from ``BamRead``.

Port of ``consensuscruncher_tpu/io/sam.py``.  Needed for (a) consuming
an external aligner's stdout in the fastq2bam stage (the reference pipes
``bwa mem`` SAM through ``samtools view -b``, SURVEY.md §3.1 — here the
pipe lands in the port's own codec), and (b) human-readable debugging.
"""

from __future__ import annotations

from typing import Iterable, Iterator, TextIO

import numpy as np

from consensuscruncher_tpu_torch.io.bam import BamHeader, BamRead, cigar_from_string
from consensuscruncher_tpu_torch.utils.phred import qual_string_to_array, array_to_qual_string


def parse_header(lines: Iterable[str]) -> BamHeader:
    """Build a BamHeader from ``@``-lines (caller peels them off the stream)."""
    text, refs = [], []
    for line in lines:
        text.append(line if line.endswith("\n") else line + "\n")
        if line.startswith("@SQ"):
            name, length = None, None
            for fld in line.rstrip("\n").split("\t")[1:]:
                if fld.startswith("SN:"):
                    name = fld[3:]
                elif fld.startswith("LN:"):
                    length = int(fld[3:])
            if name is None or length is None:
                raise ValueError(f"malformed @SQ line: {line!r}")
            refs.append((name, length))
    return BamHeader(text="".join(text), refs=refs)


def _parse_tag(fld: str) -> tuple[str, tuple[str, object]]:
    key, typ, val = fld.split(":", 2)
    if typ == "i":
        return key, ("i", int(val))
    if typ == "f":
        return key, ("f", float(val))
    if typ == "A":
        return key, ("A", val)
    if typ in ("Z", "H"):
        return key, (typ, val)
    if typ == "B":
        sub, *vals = val.split(",")
        conv = float if sub == "f" else int
        return key, ("B", (sub, [conv(v) for v in vals]))
    raise ValueError(f"unsupported SAM tag type in {fld!r}")


def parse_record(line: str) -> BamRead:
    f = line.rstrip("\n").split("\t")
    if len(f) < 11:
        raise ValueError(f"malformed SAM line ({len(f)} fields)")
    qual = np.zeros(0, dtype=np.uint8) if f[10] == "*" else qual_string_to_array(f[10])
    return BamRead(
        qname=f[0],
        flag=int(f[1]),
        ref=f[2],
        pos=int(f[3]) - 1,  # SAM is 1-based, BamRead stores 0-based like BAM
        mapq=int(f[4]),
        cigar=cigar_from_string(f[5]),
        mate_ref=f[2] if f[6] == "=" else f[6],
        mate_pos=int(f[7]) - 1,
        tlen=int(f[8]),
        seq="" if f[9] == "*" else f[9],
        qual=qual,
        tags=dict(_parse_tag(x) for x in f[11:]),
    )


def format_record(read: BamRead) -> str:
    mate = read.mate_ref
    if mate != "*" and mate == read.ref:
        mate = "="
    tags = []
    for key, (typ, val) in read.tags.items():
        if typ in "cCsSiI":
            tags.append(f"{key}:i:{val}")
        elif typ == "B":
            sub, vals = val
            tags.append(f"{key}:B:{sub}," + ",".join(str(v) for v in vals))
        else:
            tags.append(f"{key}:{typ}:{val}")
    fields = [
        read.qname,
        str(read.flag),
        read.ref,
        str(read.pos + 1),
        str(read.mapq),
        read.cigar_string(),
        mate,
        str(read.mate_pos + 1),
        str(read.tlen),
        read.seq or "*",
        array_to_qual_string(read.qual) if read.qual.size else "*",
    ]
    return "\t".join(fields + tags)


def read_sam(fh: TextIO) -> tuple[BamHeader, Iterator[BamRead]]:
    """Split a SAM text stream into (header, record iterator)."""
    header_lines: list[str] = []
    first_record: list[str] = []
    for line in fh:
        if line.startswith("@"):
            header_lines.append(line)
        else:
            first_record.append(line)
            break

    def records() -> Iterator[BamRead]:
        for line in first_record:
            if line.strip():
                yield parse_record(line)
        for line in fh:
            if line.strip():
                yield parse_record(line)

    return parse_header(header_lines), records()
