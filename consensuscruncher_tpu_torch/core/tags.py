"""UMI-family tags: the barcode conventions and the family key.

Port of the constants and ``FamilyTag`` of ``consensuscruncher_tpu/core/
tags.py`` (reference parity: ``ConsensusCruncher/consensus_helper.py:
unique_tag``), whose docstring pins the tag model.  A paired-end duplex
fragment has two genomic ends; reads group into a **family** when they share

  (barcode, ref, pos, mate_ref, mate_pos, read_number, orientation)

with the barcode recorded as ``"BC1.BC2"`` after the barcode delimiter in
the qname.  Strand A of a fragment [Lo, Hi] reads R1 forward at Lo with
barcode ``a.b``; strand B reads R1 reverse at Hi with ``b.a`` (the two UMI
halves are ligated to opposite fragment ends).  So the duplex partner of a
tag swaps the barcode halves and flips R1/R2, keeping coordinates and
orientation.  The port applies the model column-wise on its block paths
(``stages/grouping.py`` builds the keys and the duplex mirrors,
``core/qnames.py`` the SSCS/DCS qnames) and per tag with the functions
below on its object paths (the rescue and DCS window walks, the dense
wire's families), ports of the JAX module's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

BARCODE_SEP = "."
DEFAULT_BDELIM = "|"


@dataclass(frozen=True, slots=True)
class FamilyTag:
    """Immutable UMI-family key.

    ``orientation`` is the mapping strand of THIS read: ``"fwd"`` (forward) or
    ``"rev"`` (reverse-complemented alignment).  ``read_number`` is 1 or 2.
    ``ref``/``mate_ref`` are reference names (strings) so tags survive header
    renumbering; ``pos`` is the 0-based leftmost aligned position.
    """

    barcode: str
    ref: str
    pos: int
    mate_ref: str
    mate_pos: int
    read_number: int
    orientation: str

    def __str__(self) -> str:  # stable, greppable text form (stats files)
        return (
            f"{self.barcode}_{self.ref}_{self.pos}_{self.mate_ref}_{self.mate_pos}"
            f"_R{self.read_number}_{self.orientation}"
        )


def split_barcode(barcode: str) -> tuple[str, str]:
    """``"AAA.CCC" -> ("AAA", "CCC")``; a half-less barcode mirrors to itself."""
    if BARCODE_SEP in barcode:
        left, right = barcode.split(BARCODE_SEP, 1)
        return left, right
    return barcode, ""


def mirror_barcode(barcode: str) -> str:
    """Swap the two UMI halves: ``"AAA.CCC" -> "CCC.AAA"``."""
    left, right = split_barcode(barcode)
    if right == "":
        return barcode
    return f"{right}{BARCODE_SEP}{left}"


def barcode_from_qname(qname: str, bdelim: str = DEFAULT_BDELIM) -> str:
    """Extract the barcode that ``extract_barcodes`` appended to the qname.

    ``"M00001:1:000:1:1:1:1|AAA.CCC" -> "AAA.CCC"``.  Raises ``ValueError`` if
    the delimiter is absent (read did not pass barcode extraction).
    """
    base, sep, bc = qname.rpartition(bdelim)
    if not sep or not bc:
        raise ValueError(f"no barcode (delimiter {bdelim!r}) in qname {qname!r}")
    return bc


def flip_orientation(orientation: str) -> str:
    """``"fwd" <-> "rev"`` — single source of truth for the vocabulary."""
    return "fwd" if orientation == "rev" else "rev"


def unique_tag(read, barcode: str) -> FamilyTag:
    """Family key for an aligned read (reference: consensus_helper.unique_tag).

    ``read`` is any object with ``ref, pos, mate_ref, mate_pos, is_read1,
    is_reverse`` attributes (``io.bam.BamRead`` satisfies this).
    """
    return FamilyTag(
        barcode=barcode,
        ref=read.ref,
        pos=read.pos,
        mate_ref=read.mate_ref,
        mate_pos=read.mate_pos,
        read_number=1 if read.is_read1 else 2,
        orientation="rev" if read.is_reverse else "fwd",
    )


def mate_tag(tag: FamilyTag) -> FamilyTag:
    """Tag of the mate family (other read of the pair, same strand)."""
    return replace(
        tag,
        ref=tag.mate_ref,
        pos=tag.mate_pos,
        mate_ref=tag.ref,
        mate_pos=tag.pos,
        read_number=3 - tag.read_number,
        orientation=flip_orientation(tag.orientation),
    )


def duplex_tag(tag: FamilyTag) -> FamilyTag:
    """Tag of the complementary-strand family covering the same genomic end."""
    return replace(
        tag,
        barcode=mirror_barcode(tag.barcode),
        read_number=3 - tag.read_number,
    )


def _sorted_coords(tag: FamilyTag) -> tuple[str, int, str, int]:
    a = (tag.ref, tag.pos)
    b = (tag.mate_ref, tag.mate_pos)
    lo, hi = sorted((a, b))
    return lo[0], lo[1], hi[0], hi[1]


def sscs_qname(tag: FamilyTag) -> str:
    """Canonical consensus qname: identical for both mates of one strand.

    Reference: consensus_helper.sscs_qname (format pinned here, unverified
    upstream).  Includes, normalized to the fragment's *lower-coordinate*
    end, both the read number and the orientation: the read number is what
    separates the two strands of an FR duplex (strand A has R1 at the low
    end, strand B has R2 there — orientation alone cannot separate them, and
    the barcode halves collide whenever BC1 == BC2), while the orientation
    additionally separates tandem FF/RR artifact fragments.  R1/R2 of one
    strand still collide, as required for mate pairing in the output BAM.
    """
    r1, p1, r2, p2 = _sorted_coords(tag)
    # Normalize read number + orientation to the lower-coordinate end: both
    # mates of one strand agree, the two strands differ (R1 vs R2 at low end).
    low_is_self = (tag.ref, tag.pos) <= (tag.mate_ref, tag.mate_pos)
    low_rn = tag.read_number if low_is_self else 3 - tag.read_number
    low_ori = tag.orientation if low_is_self else flip_orientation(tag.orientation)
    return f"{tag.barcode}:{r1}:{p1}:{r2}:{p2}:R{low_rn}:{low_ori}"


def dcs_qname(tag: FamilyTag) -> str:
    """Canonical duplex qname: identical for both strands AND both mates."""
    bc = min(tag.barcode, mirror_barcode(tag.barcode))
    r1, p1, r2, p2 = _sorted_coords(tag)
    return f"{bc}:{r1}:{p1}:{r2}:{p2}"
