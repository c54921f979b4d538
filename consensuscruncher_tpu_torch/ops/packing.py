"""Wire format: packed member bytes for the host->device transfer.

Port of ``consensuscruncher_tpu/ops/packing.py``.  The host packers are
copied; the device unpacks are torch bit ops on the card (they are XLA
programs in the JAX package, not Pallas kernels).  Raw transfer is 2 bytes
per member-position (base uint8 + Phred uint8); basecallers emit binned
quality scores, so a batch's distinct quals almost always fit a tiny
codebook:

- pack8: bits 0-2 base code (A..PAD, 0..5), bits 3-6 qual codebook index
  (16 entries) — 1 byte per position;
- pack6: 2-bit bases (four positions per byte) next to 4-bit codebook
  indices (two per byte), concatenated on the last axis — 0.75 byte;
- pack4: base 2 bits + qual bin 2 bits, two positions per byte — 0.5 byte.

On the card the vote kernels decode the wire themselves; the torch
unpacks serve the plain versions and the tests.  The host helpers of the
reference's library (:func:`can_pack`, :func:`unpack_host`,
:func:`can_pack4`, :func:`sanitize_for_pack4`, :func:`unpack4_host`,
:func:`unpack6_host`) are numpy, as there.

Dead cells (member rows past the real members, positions past a family's
true length) decode to codebook-legal garbage; the vote never reads dead
rows and callers slice positions by true length.
"""

from __future__ import annotations

import numpy as np
import torch

CODEBOOK_SIZE = 16
_BASE_BITS = 3
_BASE_MASK = (1 << _BASE_BITS) - 1


def _build_codebook(quals: np.ndarray, size: int) -> np.ndarray | None:
    """Sorted unique quals padded to ``size`` entries, or None if they don't fit."""
    uniq = np.unique(np.asarray(quals, dtype=np.uint8))
    if uniq.size > size:
        return None
    # Pad with the max value: duplicate tail entries are harmless because
    # the qual->index LUT maps a duplicated value to its last slot and every
    # duplicate slot decodes back to the same value.
    book = np.full(size, uniq[-1] if uniq.size else 0, dtype=np.uint8)
    book[: uniq.size] = uniq
    return book


def build_codebook(quals: np.ndarray) -> np.ndarray | None:
    """1-byte wire codebook (CODEBOOK_SIZE entries)."""
    return _build_codebook(quals, CODEBOOK_SIZE)


def can_pack(quals: np.ndarray) -> bool:
    """True iff ``quals`` fit the pack8 codebook (at most 16 distinct)."""
    return np.unique(np.asarray(quals, dtype=np.uint8)).size <= CODEBOOK_SIZE


def _qual_lut(codebook: np.ndarray) -> np.ndarray:
    """256-entry qual->index LUT (O(1) per element vs searchsorted's log k;
    packing runs over tens of MB per batch, so per-element cost is the whole
    game).  Entries not in the codebook map to 255 so pack can detect them."""
    lut = np.full(256, 255, dtype=np.uint8)
    lut[codebook] = np.arange(len(codebook), dtype=np.uint8)
    return lut


def pack(bases: np.ndarray, quals: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """Pack base codes + quals into one uint8 array of the same shape."""
    bases = np.asarray(bases, dtype=np.uint8)
    quals = np.asarray(quals, dtype=np.uint8)
    from consensuscruncher_tpu_torch.io import native

    if native.available():  # fused single-pass LUT+pack (same errors)
        return native.pack_wire(bases, quals, _qual_lut(codebook), four_bit=False)
    if bases.max(initial=0) > _BASE_MASK:
        raise ValueError("base codes exceed 3 bits")
    idx = _qual_lut(codebook)[quals]
    if idx.max(initial=0) >= CODEBOOK_SIZE:
        raise ValueError("quals not in codebook — rebuild with build_codebook")
    return bases | (idx << _BASE_BITS)


def unpack_host(packed: np.ndarray, codebook: np.ndarray):
    """Host inverse of :func:`pack`: ``(bases, quals)`` uint8 arrays."""
    packed = np.asarray(packed, dtype=np.uint8)
    return packed & _BASE_MASK, np.asarray(codebook, dtype=np.uint8)[packed >> _BASE_BITS]


def _lookup(codebook: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return codebook.to(device=idx.device, dtype=torch.uint8)[idx.long()]


def unpack_device(packed: torch.Tensor, codebook: torch.Tensor):
    """Inverse of :func:`pack` on the tensor's device.

    Args: ``packed`` uint8 tensor (any shape), ``codebook`` (16,) uint8.
    Returns ``(bases, quals)`` uint8 tensors of the same shape.
    """
    return packed & _BASE_MASK, _lookup(codebook, packed >> _BASE_BITS)


# 4-bit mode: two member-positions per byte (base 2 bits + qual-bin 2 bits)
# for ACGT-only reads with at most four distinct quals.

CODEBOOK4_SIZE = 4


def build_codebook4(quals: np.ndarray) -> np.ndarray | None:
    """4-bit wire codebook (CODEBOOK4_SIZE entries)."""
    return _build_codebook(quals, CODEBOOK4_SIZE)


def can_pack4(bases: np.ndarray, quals: np.ndarray) -> bool:
    """True iff bases are pure ACGT and quals fit a 4-entry codebook."""
    return (int(np.asarray(bases, dtype=np.uint8).max(initial=0)) < 4
            and np.unique(np.asarray(quals, dtype=np.uint8)).size <= CODEBOOK4_SIZE)


def sanitize_for_pack4(bases: np.ndarray, quals: np.ndarray, fam_sizes: np.ndarray,
                       fill_qual: int, lengths: np.ndarray | None = None):
    """Rewrite the dead slots of a padded ``(B, F, L)`` batch so it packs:
    member rows ``>= fam_sizes`` (and, given ``lengths``, positions ``>=``
    each family's true length), PAD and qual 0 from the batching layer,
    become (base A, ``fill_qual``), ``fill_qual`` any codebook value.  The
    vote never reads dead rows, but a live row's padded positions then vote
    A where they voted N: callers slice outputs to ``lengths``.  Returns
    new arrays; then :func:`can_pack4` decides on the live data alone."""
    bases = np.asarray(bases, dtype=np.uint8).copy()
    quals = np.asarray(quals, dtype=np.uint8).copy()
    fam_sizes = np.asarray(fam_sizes)
    dead = np.arange(bases.shape[1])[None, :, None] >= fam_sizes[:, None, None]
    if lengths is not None:
        dead = dead | (np.arange(bases.shape[2])[None, None, :]
                       >= np.asarray(lengths)[:, None, None])
    dead = np.broadcast_to(dead, bases.shape)
    bases[dead] = 0
    quals[dead] = fill_qual
    return bases, quals


def pack4(bases: np.ndarray, quals: np.ndarray, codebook4: np.ndarray) -> np.ndarray:
    """Pack to two positions per byte along the last axis.

    Returns uint8 of shape ``(..., ceil(L/2))``; odd lengths are padded with
    a zero nibble (decoded as base A / bin-0 qual — callers slice by true
    length, see module note).
    """
    bases = np.asarray(bases, dtype=np.uint8)
    quals = np.asarray(quals, dtype=np.uint8)
    from consensuscruncher_tpu_torch.io import native

    if native.available():  # fused single-pass LUT+nibble pack (same errors)
        return native.pack_wire(bases, quals, _qual_lut(codebook4), four_bit=True)
    if bases.max(initial=0) > 3:
        raise ValueError("4-bit mode requires pure-ACGT bases")
    idx = _qual_lut(codebook4)[quals]
    if idx.max(initial=0) >= CODEBOOK4_SIZE:
        raise ValueError("quals not in 4-entry codebook")
    nib = bases | (idx << 2)  # (..., L) 4-bit values
    if nib.shape[-1] % 2:
        pad = np.zeros(nib.shape[:-1] + (1,), np.uint8)
        nib = np.concatenate([nib, pad], axis=-1)
    return (nib[..., 0::2] | (nib[..., 1::2] << 4)).astype(np.uint8)


def unpack4_host(packed: np.ndarray, codebook4: np.ndarray, length: int):
    """Host inverse of :func:`pack4`; ``length`` is the true position
    count before nibble padding."""
    packed = np.asarray(packed, dtype=np.uint8)
    nib = np.empty(packed.shape[:-1] + (packed.shape[-1] * 2,), np.uint8)
    nib[..., 0::2] = packed & 0xF
    nib[..., 1::2] = packed >> 4
    nib = nib[..., :length]
    return nib & 3, np.asarray(codebook4, dtype=np.uint8)[nib >> 2]


def unpack4_device(packed: torch.Tensor, codebook4: torch.Tensor, length: int):
    """Inverse of :func:`pack4` on the tensor's device; ``length`` is the
    true position count before nibble padding."""
    nib = torch.stack([packed & 0xF, packed >> 4], dim=-1)
    nib = nib.reshape(packed.shape[:-1] + (packed.shape[-1] * 2,))[..., :length]
    return nib & 3, _lookup(codebook4, nib >> 2)


# 6-bit split mode: ACGT-only reads whose quals need 5..16 distinct values.


def pack6(bases: np.ndarray, quals: np.ndarray, codebook: np.ndarray,
          qual_lut: np.ndarray | None = None) -> np.ndarray:
    """Pack to the 6-bit split wire along the last axis.

    Returns uint8 of shape ``(..., 3 * ceil(L/4))``: the 2-bit-packed bases
    block followed by the 4-bit-packed qual-index block.  Lengths are padded
    to a multiple of 4 with zero cells (decoded as base A / codebook slot 0
    — callers slice by true length).  ``qual_lut`` overrides the
    codebook-derived qual->index LUT (e.g. to fold a fill sentinel to slot
    0 without a full-batch rewrite).
    """
    bases = np.asarray(bases, dtype=np.uint8)
    quals = np.asarray(quals, dtype=np.uint8)
    if bases.max(initial=0) > 3:
        raise ValueError("6-bit mode requires pure-ACGT bases")
    idx = (_qual_lut(codebook) if qual_lut is None else qual_lut)[quals]
    if idx.max(initial=0) >= CODEBOOK_SIZE:
        raise ValueError("quals not in codebook — rebuild with build_codebook")
    pad = (-bases.shape[-1]) % 4
    if pad:
        zeros = np.zeros(bases.shape[:-1] + (pad,), np.uint8)
        bases = np.concatenate([bases, zeros], axis=-1)
        idx = np.concatenate([idx, zeros], axis=-1)
    b2 = (bases[..., 0::4] | (bases[..., 1::4] << 2)
          | (bases[..., 2::4] << 4) | (bases[..., 3::4] << 6))
    q4 = (idx[..., 0::2] | (idx[..., 1::2] << 4)).astype(np.uint8)
    return np.concatenate([b2.astype(np.uint8), q4], axis=-1)


def unpack6_host(packed: np.ndarray, codebook: np.ndarray, length: int):
    """Host inverse of :func:`pack6`; ``length`` is the true position count
    before the pad to a multiple of 4."""
    packed = np.asarray(packed, dtype=np.uint8)
    w = packed.shape[-1] // 3
    b2, q4 = packed[..., :w], packed[..., w:]
    bases = np.empty(packed.shape[:-1] + (4 * w,), np.uint8)
    for k in range(4):
        bases[..., k::4] = (b2 >> (2 * k)) & 3
    idx = np.empty(packed.shape[:-1] + (4 * w,), np.uint8)
    idx[..., 0::2] = q4 & 0xF
    idx[..., 1::2] = q4 >> 4
    return bases[..., :length], np.asarray(codebook, dtype=np.uint8)[idx[..., :length]]


def unpack6_device(packed: torch.Tensor, codebook: torch.Tensor, length: int):
    """Inverse of :func:`pack6` on the tensor's device; ``length`` is the
    true position count before pad-to-4."""
    w = packed.shape[-1] // 3
    b2, q4 = packed[..., :w], packed[..., w:]
    wide = packed.shape[:-1] + (4 * w,)
    bases = torch.stack([(b2 >> (2 * k)) & 3 for k in range(4)], dim=-1)
    idx = torch.stack([q4 & 0xF, q4 >> 4], dim=-1)
    return (bases.reshape(wide)[..., :length],
            _lookup(codebook, idx.reshape(wide)[..., :length]))


# The four member-stream wires, densest last; the vote kernels decode each
# in place (csrc/consensus_vote.cu), the plain versions through unpack_wire.
WIRES = ("raw", "pack8", "pack6", "pack4")


def wire_width(wire: str, a) -> int:
    """Positions per member row of a wire batch whose first array is ``a``."""
    if wire in ("raw", "pack8"):
        return a.shape[-1]
    if wire == "pack6":
        return a.shape[-1] // 3 * 4
    if wire == "pack4":
        return 2 * a.shape[-1]
    raise ValueError(f"unknown wire {wire!r}")


def encode_wire(wire: str, bases: np.ndarray, quals: np.ndarray):
    """Host encode of ``(M, L)`` uint8 bases and quals on the named wire ->
    ``(a, b)`` as :func:`unpack_wire` takes them, the codebook built from
    the quals (pack4 and pack6 need pure-ACGT bases; pack4 at most four
    distinct quals, pack8 and pack6 at most sixteen)."""
    bases = np.asarray(bases, dtype=np.uint8)
    quals = np.asarray(quals, dtype=np.uint8)
    if wire == "raw":
        return bases, quals
    book = (build_codebook4 if wire == "pack4" else build_codebook)(quals)
    if book is None:
        raise ValueError(f"too many distinct quals for the {wire} codebook")
    packer = {"pack8": pack, "pack6": pack6, "pack4": pack4}.get(wire)
    if packer is None:
        raise ValueError(f"unknown wire {wire!r}")
    return packer(bases, quals, book), book


def unpack_wire(wire: str, a: torch.Tensor, b: torch.Tensor):
    """Decode of one wire batch with torch ops -> ``(bases, quals)`` ``(M,
    L)`` uint8 planes on ``a``'s device: raw = (bases, quals); packed =
    (packed rows, codebook)."""
    if wire == "raw":
        return a, b
    if wire == "pack8":
        return unpack_device(a, b)
    if wire == "pack6":  # 3/4 byte per position, lengths a multiple of 4
        return unpack6_device(a, b, wire_width(wire, a))
    if wire == "pack4":  # length buckets are multiples of 32
        return unpack4_device(a, b, wire_width(wire, a))
    raise ValueError(f"unknown wire {wire!r}")


# Device residency: the consensus planes the SSCS vote produces stay on the
# device for rescue and DCS (implementation in ops.residency; this factory
# is the wire-format module's entry point, as in the JAX package).


def resident_planes(device: torch.device | str, qual_cap: int = 60):
    """Create a per-run :class:`ops.residency.ResidentPlanes` store on
    ``device``.  Thread it through ``run_sscs(residency=...)`` (capture),
    ``run_singleton_correction(residency=...)`` and
    ``run_dcs(residency=...)`` (gathers).  ``qual_cap`` must match the
    stages' duplex cap."""
    from consensuscruncher_tpu_torch.ops.residency import ResidentPlanes

    return ResidentPlanes(device, qual_cap=qual_cap)
