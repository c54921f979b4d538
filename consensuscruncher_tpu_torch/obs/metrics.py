"""Process-wide transfer-byte and build counters of the port.

Port of the parts of ``consensuscruncher_tpu/obs/metrics.py`` that the
per-stage ``*.metrics.json`` sidecars read: ``note_transfer`` /
``transfer_bytes`` and ``recompiles``.  Stages snapshot them before and
after their work and publish the difference in their ``cumulative``
block.

- Transfer bytes are counted at the port's own upload and download sites
  on the consensus path (the stream and dense votes, the duplex votes,
  the residency gathers, the Hamming matcher, the QC total), and only
  when the copy crosses to or from a CUDA device: a ``--device cpu`` run
  counts 0.
- The port has no JIT, so nothing recompiles per shape as XLA does.
  ``recompiles`` counts the kernel libraries that ``ops.cuda_lib.build``
  compiled with ``nvcc`` in this process (0 once ``_build/`` holds them).

The histogram hub and the Prometheus rendering come with the serve plane.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_transfer_bytes = {"h2d": 0, "d2h": 0}
_builds = 0


def note_transfer(direction: str, nbytes: int, device=None) -> None:
    """Record ``nbytes`` moved host->device (``"h2d"``) or device->host
    (``"d2h"``).  ``device``: the device side of the copy; a copy that
    stays on the CPU counts nothing (the port's CPU runs move no bytes
    over a bus)."""
    if direction not in _transfer_bytes:
        raise KeyError(f"transfer direction must be 'h2d' or 'd2h', got {direction!r}")
    if device is not None and getattr(device, "type", device) != "cuda":
        return
    with _lock:
        _transfer_bytes[direction] += int(nbytes)


def transfer_bytes() -> dict:
    """Snapshot ``{"h2d": total_bytes, "d2h": total_bytes}``."""
    with _lock:
        return dict(_transfer_bytes)


def note_build() -> None:
    """Record one kernel library compiled by ``nvcc`` in this process."""
    global _builds
    with _lock:
        _builds += 1


def recompiles() -> int:
    """Kernel libraries built in this process (the port's counterpart of
    the JAX package's first-sighting dispatch signatures)."""
    with _lock:
        return _builds

