"""Hamming barcode matcher of the singleton rescue (``--max_mismatch > 0``).

Port of ``consensuscruncher_tpu/ops/singleton_tpu.py`` (B10: the jitted
``_compiled_tile``, an all-pairs mismatch count of two ``(n, L)`` /
``(m, L)`` uint8 barcode matrices, an XLA program rather than a Pallas
kernel, so torch ops on the card here) and of its ambiguity rule
(``best_matches``): a query takes the unique best candidate within
``max_mismatch``; a tie for best, or an empty pool, gives ``-1``; pool
order decides which index is returned.

Two ways in:

- :func:`pairwise_hamming` / :func:`best_matches`, the reference's API:
  all pairs of two matrices, tiled;
- :func:`pair_distances`: the distances of an explicit list of
  ``(query row, candidate row)`` pairs.  The rescue walk computes every
  distance of a chunk of position windows with one such call (each
  window's mirrored singleton barcodes against its SSCS and singleton
  barcodes) and replays its decisions on the host with :func:`choose`,
  instead of one device call (a launch plus a synchronising copy back)
  per singleton as the JAX walk makes.

Each runs on ``device``: the card, or its plain numpy version when the
device is the CPU.  ``launches`` counts the device calls on the card (each
a gather, a compare and a row sum) and ``hamming_s`` their synchronised
wall seconds, uploads and the copy back included.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from consensuscruncher_tpu_torch.device import resolve_device

launches = 0
hamming_s = 0.0


def _as_codes(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.uint8))


def _on_card(fn):
    """Run ``fn()`` (device work ending in a host copy) as one counted,
    timed device call."""
    global launches, hamming_s
    t0 = time.perf_counter()
    out = fn()
    hamming_s += time.perf_counter() - t0
    launches += 1
    return out


def pairwise_hamming_plain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Plain numpy version of :func:`pairwise_hamming`: ``(n, m)`` int32."""
    return (a[:, None, :] != b[None, :, :]).sum(axis=-1, dtype=np.int32)


def pairwise_hamming(a, b, tile: int = 2048, device=None) -> np.ndarray:
    """All-pairs Hamming distance between two barcode code matrices.

    ``a``: ``(n, L)`` uint8 codes; ``b``: ``(m, L)`` uint8 codes (same
    ``L``); ``tile``: most rows of each side per device call.  Returns the
    ``(n, m)`` int32 distance matrix on the host, computed on ``device``
    (default: the card; the CPU runs the plain version)."""
    a, b = _as_codes(a), _as_codes(b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"barcode matrices must be (n, L)/(m, L), got {a.shape}/{b.shape}")
    dev = resolve_device(device)
    out = np.empty((a.shape[0], b.shape[0]), dtype=np.int32)
    for i in range(0, a.shape[0], tile):
        for j in range(0, b.shape[0], tile):
            ta, tb = a[i:i + tile], b[j:j + tile]
            if dev.type == "cpu":
                block = pairwise_hamming_plain(ta, tb)
            else:
                def call(ta=ta, tb=tb):
                    da = torch.from_numpy(ta).to(dev)
                    db = torch.from_numpy(tb).to(dev)
                    return (da[:, None, :] != db[None, :, :]).sum(
                        -1, dtype=torch.int32).cpu().numpy()
                block = _on_card(call)
            out[i:i + tile, j:j + tile] = block
    return out


def choose(dist: np.ndarray, max_mismatch: int) -> np.ndarray:
    """``best_matches``' rule over an ``(n, m)`` distance matrix: per row,
    the first index of the unique minimum if it is ``<= max_mismatch``,
    else ``-1`` (a tie for best is ambiguous; ``m == 0`` has no
    candidate)."""
    dist = np.asarray(dist)
    if dist.shape[1] == 0:
        return np.full(dist.shape[0], -1, dtype=np.int64)
    best = dist.argmin(axis=1)
    best_d = dist[np.arange(dist.shape[0]), best]
    ties = (dist == best_d[:, None]).sum(axis=1) > 1
    return np.where((best_d <= max_mismatch) & ~ties, best, -1)


def best_matches(a, b, max_mismatch: int, tile: int = 2048, device=None) -> np.ndarray:
    """For each row of ``a``: index of the unique best row of ``b`` within
    ``max_mismatch``, or -1 (no candidate / ambiguous tie for best)."""
    b = _as_codes(b)
    if b.shape[0] == 0:
        return np.full(np.shape(a)[0], -1, dtype=np.int64)
    return choose(pairwise_hamming(a, b, tile=tile, device=device), max_mismatch)


def pair_distances(codes: np.ndarray, qi: np.ndarray, pj: np.ndarray,
                   device=None, max_pairs: int = 1 << 22) -> np.ndarray:
    """Hamming distances ``(P,)`` int32 between rows ``codes[qi[k]]`` and
    ``codes[pj[k]]`` of one ``(R, W)`` uint8 barcode matrix (shorter
    barcodes padded with a byte that is no code, so they differ there):
    one counted device call, its pairs in slices of ``max_pairs``; the
    plain version on the CPU."""
    codes = _as_codes(codes)
    qi = np.asarray(qi, dtype=np.int64)
    pj = np.asarray(pj, dtype=np.int64)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return (codes[qi] != codes[pj]).sum(axis=1, dtype=np.int32)
    out = np.empty(qi.shape[0], dtype=np.int32)

    def call():
        table = torch.from_numpy(codes).to(dev)
        for s in range(0, qi.shape[0], max_pairs):
            q = torch.from_numpy(qi[s:s + max_pairs]).to(dev)
            p = torch.from_numpy(pj[s:s + max_pairs]).to(dev)
            d = (table.index_select(0, q) != table.index_select(0, p)).sum(
                1, dtype=torch.int32)
            out[s:s + max_pairs] = d.cpu().numpy()
        return out

    if qi.shape[0] == 0:
        return out
    return _on_card(call)
