"""Consensus read assembly: modal cigar, flag policy, the consensus record.

Port of ``consensuscruncher_tpu/core/consensus_read.py`` (reference
parity: ``ConsensusCruncher/consensus_helper.py:create_aligned_segment``):
a consensus record takes its template from the family's first member and
keeps only the pairing/strand/read-number bits of its flag (paired,
proper, reverse, mate-reverse, read1, read2); consensus reads are never
secondary, supplementary, duplicate or qcfail by construction.  Its cigar
is the modal cigar of the members whose length equals the consensus
length, its mapq the members' maximum.  Tags: ``XT:Z`` the family tag,
``XF:i`` the family size.  The block paths build the same bytes column by
column; :func:`modal_cigar` serves the dense wire's mixed-cigar families,
and :func:`build_consensus_read` (with ``io.bam.encode_record``) is the
object form the tests hold those records to.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from consensuscruncher_tpu_torch.core.tags import FamilyTag
from consensuscruncher_tpu_torch.io.bam import (
    BamRead,
    FMREVERSE,
    FPAIRED,
    FPROPER,
    FREAD1,
    FREAD2,
    FREVERSE,
    cigar_from_string,
)
from consensuscruncher_tpu_torch.utils.phred import decode_seq

_KEEP_FLAGS = FPAIRED | FPROPER | FREVERSE | FMREVERSE | FREAD1 | FREAD2


def modal_cigar(members: list, seq_length: int) -> list[tuple[str, int]]:
    """Modal cigar among members whose read length matches the consensus
    length (ties -> first seen); ``[("M", seq_length)]`` when none does.

    ``members`` may be ``io.bam.BamRead`` or the columnar ``MemberView`` —
    both expose ``seq_len`` / ``cigar_string()`` / ``mapq``."""
    candidates = [m for m in members if m.seq_len == seq_length]
    if not candidates:  # all members truncated (target longer than every read)
        return [("M", seq_length)]
    counts = Counter(m.cigar_string() for m in candidates)
    return cigar_from_string(counts.most_common(1)[0][0])


def build_consensus_read(
    tag: FamilyTag,
    members: list,
    codes: np.ndarray,
    quals: np.ndarray,
    qname: str,
    extra_tags: dict | None = None,
) -> BamRead:
    template = members[0]
    bam_tags = {
        "XT": ("Z", str(tag)),
        "XF": ("i", len(members)),
    }
    if extra_tags:
        bam_tags.update(extra_tags)
    return BamRead(
        qname=qname,
        flag=template.flag & _KEEP_FLAGS,
        ref=template.ref,
        pos=template.pos,
        mapq=max(m.mapq for m in members),
        cigar=modal_cigar(members, len(codes)),
        mate_ref=template.mate_ref,
        mate_pos=template.mate_pos,
        tlen=template.tlen,
        seq=decode_seq(codes),
        qual=np.asarray(quals, dtype=np.uint8),
        tags=bam_tags,
    )
