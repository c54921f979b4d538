"""Minimal FASTA reader (plain or gzipped).

Port of ``consensuscruncher_tpu/io/fasta.py``.  Feeds the built-in
aligner (``stages.align``): the reference pipeline hands the FASTA
straight to ``bwa`` and never parses it itself, so this has no upstream
counterpart; it lets ``fastq2bam`` run without external binaries.
"""

from __future__ import annotations

import gzip
from typing import Iterator


def _open_text(path):
    p = str(path)
    return gzip.open(p, "rt") if p.endswith(".gz") else open(p)


def iter_fasta(path) -> Iterator[tuple[str, str]]:
    """Yield ``(name, sequence)`` per record; name is the first token."""
    name, parts = None, []
    with _open_text(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(parts)
                name, parts = line[1:].split()[0], []
            else:
                if name is None:
                    raise ValueError("FASTA content before first '>' header")
                parts.append(line.upper())
        if name is not None:
            yield name, "".join(parts)


def read_fasta(path) -> dict[str, str]:
    """Whole-file load: ``{name: sequence}`` (small/test genomes)."""
    out: dict[str, str] = {}
    for name, seq in iter_fasta(path):
        if name in out:
            raise ValueError(f"duplicate FASTA record {name!r}")
        out[name] = seq
    return out


def write_fasta(path, records: dict[str, str], width: int = 70) -> None:
    with open(path, "w") as fh:
        for name, seq in records.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")
