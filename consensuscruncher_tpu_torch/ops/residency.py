"""Device-resident consensus planes: keep the SSCS vote output on the card.

Port of ``consensuscruncher_tpu/ops/residency.py``.  The staged pipeline
writes the SSCS consensus to a BAM; singleton rescue and DCS then re-read
those bytes and upload them again for their duplex votes.  This store keeps
the ``(2, n_real, out_len)`` planes the SSCS stage's vote produced (captured
before they are downloaded), indexes them by SSCS qname + NUL + the 2-byte
little-endian record flag (R1 and R2 records share the family qname), and
serves the downstream duplex votes as gathers on the card:

- DCS pairing uploads two index vectors instead of four ``(k, L)`` planes
  (:meth:`ResidentPlanes.duplex_pairs`);
- singleton rescue uploads only the singleton half, gathers the SSCS
  partner from the store, and registers its own output under the
  singleton's key so the later DCS pass gathers it too
  (:meth:`ResidentPlanes.duplex_against`).

The gathers are ``index_select`` plus ``ops.duplex.duplex_vote`` (XLA
programs in the JAX package, B8).  Byte parity is by construction: the
resident rows hold exactly the codes/quals the SSCS records were written
from, and the vote is the same pinned duplex formula.

**Departure from the reference:** the JAX store catches any device error,
clears itself and lets the stages fall back to uploads.  The port raises
instead: no fallback may hide the device.  A miss (a key that was never
stored, or stored at another length) is data routing, not a failure, and
still votes by upload, as in the reference.
"""

from __future__ import annotations

from itertools import repeat

import numpy as np
import torch

from consensuscruncher_tpu_torch.core.consensus_cpu import DEFAULT_QUAL_CAP
from consensuscruncher_tpu_torch.ops.duplex import duplex_vote
from consensuscruncher_tpu_torch.utils.ragged import scatter_runs

# Duplex votes served from a store since the last reset: DCS pairs gathered
# on both sides, and rescues gathered against a resident SSCS.  Module
# counters, not stats keys: a new key in the stats JSON would change the
# golden digests.
pair_votes = 0
against_votes = 0


def record_keys(data: np.ndarray, starts, lens, flags) -> np.ndarray:
    """Store keys of ``n`` records as one numpy bytes array, built without a
    per-record Python loop: record ``i``'s qname is ``data[starts[i]:
    +lens[i]]`` (no NUL), and its key is that qname + NUL + the 2-byte
    little-endian ``flags[i]``.

    A numpy bytes array drops trailing NULs (a flag below 256 loses its
    high byte, flag 0 its separator too); the mapping stays one-to-one
    because a qname holds no NUL, and :class:`ResidentPlanes` compares
    every key in this form."""
    lens = np.asarray(lens, np.int64)
    n = len(lens)
    width = int(lens.max(initial=0)) + 3
    out = np.zeros(n * width, np.uint8)
    dst = np.arange(n, dtype=np.int64) * width
    scatter_runs(out, dst, np.ascontiguousarray(data, np.uint8), lens,
                 src_starts=np.asarray(starts, np.int64))
    flags = np.asarray(flags, np.int64)
    out[dst + lens + 1] = flags & 0xFF
    out[dst + lens + 2] = flags >> 8
    return out.view(f"S{width}")


def _as_keys(keys) -> list[bytes]:
    """Keys as hashable bytes in the store's form (see :func:`record_keys`):
    a numpy bytes array, or any sequence of bytes-like keys."""
    if not isinstance(keys, np.ndarray):
        keys = np.array([bytes(k) for k in keys], dtype=np.bytes_)
    return keys.tolist()


class ResidentPlanes:
    """Per-run store of consensus planes on ``device``, keyed by bytes.

    Rows live in one ``(2, capacity, width)`` uint8 buffer that grows by
    doubling, so an append copies only its own rows (amortized) and a
    gather never needs a consolidation pass.  Keys are bytes (see
    :func:`record_keys`), looked up in one dict; each row's true length is
    a numpy array beside the planes.  Single-threaded use per run (the
    stage loops are serial).
    """

    def __init__(self, device: torch.device | str, qual_cap: int = DEFAULT_QUAL_CAP):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:  # tensors name their card
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.qual_cap = int(qual_cap)
        self._planes: torch.Tensor | None = None
        self._rows = 0
        self._lengths = np.zeros(0, np.int64)  # true length per row
        self._index: dict[bytes, int] = {}  # key -> row

    def append(self, keys, lengths, planes: torch.Tensor, n_real: int) -> None:
        """Register rows ``0..n_real-1`` of the stacked ``(2, n, L)`` planes
        under ``keys``, each stored at its true length ``lengths[i]``."""
        if planes.device != self.device:
            raise ValueError(f"planes on {planes.device}, store on {self.device}")
        if n_real == 0:
            return
        width = int(planes.shape[2])
        end = self._rows + n_real
        self._reserve(end, width)
        self._planes[:, self._rows:end, :width].copy_(planes[:, :n_real])
        self._lengths[self._rows:end] = np.asarray(lengths[:n_real], np.int64)
        self._index.update(zip(_as_keys(keys), range(self._rows, end)))
        self._rows = end

    def _reserve(self, rows: int, width: int) -> None:
        old = self._planes
        if old is not None and rows <= old.shape[1] and width <= old.shape[2]:
            return
        cap = rows
        if old is not None:
            cap = old.shape[1] if rows <= old.shape[1] else max(rows, 2 * old.shape[1])
            width = max(width, old.shape[2])
        self._planes = torch.empty((2, cap, width), dtype=torch.uint8, device=self.device)
        if old is not None:
            self._planes[:, :self._rows, :old.shape[2]].copy_(old[:, :self._rows])
        lengths = np.zeros(cap, np.int64)
        lengths[:self._rows] = self._lengths[:self._rows]
        self._lengths = lengths

    @property
    def families(self) -> int:
        return len(self._index)

    def rows_for(self, keys, length: int) -> np.ndarray | None:
        """Resident row per key, -1 on a miss (absent, or stored at another
        length — a length-L vote must read length-L rows).  None when the
        store is empty (callers vote everything by upload)."""
        if not self._index:
            return None
        keys = _as_keys(keys)
        out = np.fromiter(map(self._index.get, keys, repeat(-1)), np.int64, len(keys))
        out[(out >= 0) & (self._lengths[out] != int(length))] = -1
        return out

    def _gather(self, idx: np.ndarray, length: int):
        rows = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(self.device)
        picked = self._planes[:, :, :length].index_select(1, rows)
        return picked[0], picked[1]

    def duplex_pairs(self, idx1: np.ndarray, idx2: np.ndarray, length: int,
                     qual_cap: int | None = None):
        """Duplex vote of resident row pairs (the DCS shape); the upload is
        the two index vectors.  Returns host ``(out_b, out_q)``
        ``(k, length)`` arrays."""
        global pair_votes
        qc = self.qual_cap if qual_cap is None else int(qual_cap)
        b1, q1 = self._gather(idx1, length)
        b2, q2 = self._gather(idx2, length)
        out = torch.stack(duplex_vote(b1, q1, b2, q2, qual_cap=qc)).cpu().numpy()
        pair_votes += len(idx1)
        return out[0], out[1]

    def duplex_against(self, s1: np.ndarray, q1: np.ndarray, idx2: np.ndarray,
                       length: int, register_keys=None, qual_cap: int | None = None):
        """Duplex vote of uploaded ``(k, length)`` halves against resident
        partner rows (the rescue shape: singleton vs resident SSCS).
        ``register_keys`` keeps the output planes resident under those keys
        so the later DCS pass gathers them too.  Returns host
        ``(out_b, out_q)`` ``(k, length)`` arrays."""
        global against_votes
        qc = self.qual_cap if qual_cap is None else int(qual_cap)
        up = [torch.from_numpy(np.ascontiguousarray(x[:, :length], dtype=np.uint8))
              .to(self.device) for x in (s1, q1)]
        b2, q2 = self._gather(idx2, length)
        planes = torch.stack(duplex_vote(up[0], up[1], b2, q2, qual_cap=qc))
        k = len(idx2)
        if register_keys is not None:
            self.append(register_keys, [length] * k, planes, k)
        out = planes.cpu().numpy()
        against_votes += k
        return out[0], out[1]
