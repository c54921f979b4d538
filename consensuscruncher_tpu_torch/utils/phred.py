"""Base/quality encodings shared by the host code and the device votes.

Encoding contract (load-bearing for host<->device bit parity):

- Bases are small ints: A=0, C=1, G=2, T=3, N=4.  PAD=5 marks padding slots in
  batched tensors (never a real base).  Any IUPAC ambiguity code other than
  ACGT maps to N, matching how the reference treats them (everything non-ACGT
  is just an uncounted/modal-losing base in ``collections.Counter``).
- Qualities are raw Phred ints (0..93) as stored in BAM ``qual`` bytes; the
  Sanger ASCII offset (33) only appears at FASTQ/SAM text boundaries.
"""

from __future__ import annotations

import numpy as np

SANGER_OFFSET = 33

A, C, G, T, N = 0, 1, 2, 3, 4
PAD = 5
NUM_BASES = 5  # A C G T N participate in voting

BASE_CHARS = "ACGTN"

# uint8 ascii -> code lookup (everything unknown -> N)
_ENCODE_LUT = np.full(256, N, dtype=np.uint8)
for _i, _ch in enumerate(BASE_CHARS):
    _ENCODE_LUT[ord(_ch)] = _i
    _ENCODE_LUT[ord(_ch.lower())] = _i

_DECODE_LUT = np.frombuffer(b"ACGTN?", dtype=np.uint8)


def encode_seq(seq: str | bytes) -> np.ndarray:
    """str/bytes sequence -> uint8 codes (A=0..N=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENCODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> str:
    """uint8 codes -> str sequence ('?' for PAD, which should never leak out)."""
    return _DECODE_LUT[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def quals_to_array(quals) -> np.ndarray:
    """List/iterable of Phred ints -> uint8 array."""
    return np.asarray(quals, dtype=np.uint8)


def qual_string_to_array(qual_str: str | bytes) -> np.ndarray:
    """Sanger-encoded ASCII quality string -> Phred uint8 array."""
    if isinstance(qual_str, str):
        qual_str = qual_str.encode("ascii")
    arr = np.frombuffer(qual_str, dtype=np.uint8)
    return (arr - SANGER_OFFSET).astype(np.uint8)


def array_to_qual_string(arr: np.ndarray) -> str:
    """Phred uint8 array -> Sanger ASCII quality string."""
    return (np.asarray(arr, dtype=np.uint8) + SANGER_OFFSET).tobytes().decode("ascii")


def complement_codes(codes: np.ndarray) -> np.ndarray:
    """A<->T, C<->G, N->N on the integer encoding."""
    lut = np.array([T, G, C, A, N, PAD], dtype=np.uint8)
    return lut[np.asarray(codes, dtype=np.uint8)]


_REVCOMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def revcomp_str(seq: str) -> str:
    """Reverse complement of a base string (ACGTN, either case)."""
    return seq.translate(_REVCOMP)[::-1]
