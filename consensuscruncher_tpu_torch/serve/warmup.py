"""Startup warmup: the kernel build directory + warm launches.

Port of ``consensuscruncher_tpu/serve/warmup.py``.  The JAX daemon pays
its XLA compiles once per lifetime; the port has no per-shape compile,
but its first vote still pays the ``nvcc`` build of the kernel library
(``ops.cuda_lib``, minutes on a cold build directory) and the card's
context and module load.  The daemon pays those before it serves:

- :func:`setup_compilation_cache` points the kernel build directory at a
  directory of the caller's, so a daemon *restart* (or a fresh checkout)
  reuses the built library: that directory is the port's persistent
  compile cache.  The default, ``consensuscruncher_tpu_torch/_build/``,
  is git-ignored.
- :func:`warm_shapes` builds the library at first use and launches B1's
  dense form once per configured ``BxFxL`` bucket (the gang wire), or
  once at :data:`LIBRARY_WARM_SHAPE` when none is configured, so the
  first request never eats a cold build.
- :func:`warm_join` reads a fleet's warm state off its ring view
  (``serve --warm_from``): the shared build directory, where the router
  already built the library, and the result-cache plane.

A failed warm launch raises: on the port's serving path nothing degrades
to the CPU or to a plain version.  The JAX package's bucket autotuner
(the learned shape table, its warmup ladder and the dense-XLA-vs-Pallas
race) is not ported: nothing here compiles per shape, and the port runs a
dense bucket one way, B1's dense form; a second way to race comes with
the autotuner's measuring half (ROADMAP A11).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

#: the one warm launch when no ``--warmup_shapes`` are given: small, since
#: it only builds and loads the kernel library and the card's context
LIBRARY_WARM_SHAPE = (8, 2, 32)


def setup_compilation_cache(cache_dir: str) -> bool:
    """Build (and look up) the kernel libraries under ``cache_dir``: the
    port's persistent compile cache.  Returns True when the directory is
    usable, else warns and keeps the default build directory."""
    from consensuscruncher_tpu_torch.ops import cuda_lib

    try:
        os.makedirs(cache_dir, exist_ok=True)
        if not os.access(cache_dir, os.W_OK):
            raise PermissionError(f"{cache_dir} is not writable")
    except OSError as e:
        print(f"WARNING: kernel build directory {cache_dir} unusable ({e}); "
              f"building under {cuda_lib.BUILD_DIR}", file=sys.stderr, flush=True)
        return False
    cuda_lib.set_build_dir(cache_dir)
    return True


def warm_join(view_path: str) -> dict:
    """The ``warm`` record of the newest epoch in the ring view at
    ``view_path``: ``compile_cache`` (the fleet's kernel build directory)
    and ``result_cache`` (its cache plane) are what the caller adopts.  An
    ``autotune_table`` (a JAX router's view carries one) is named on
    stderr as ignored: the port keeps no bucket table.  A
    view with no warm state joins cold, with a warning."""
    from consensuscruncher_tpu_torch.serve.router import RingView

    doc = RingView(view_path).load() or {}
    warm = dict(doc.get("warm") or {})
    if not warm:
        print(f"WARNING: serve: --warm_from {view_path} carries no warm state; "
              "joining cold", file=sys.stderr, flush=True)
        return {}
    print(f"serve: warm-join state from {view_path} (epoch {doc.get('epoch')}): "
          f"{', '.join(sorted(warm))}", flush=True)
    if warm.pop("autotune_table", None):
        print("serve: warm-join autotune_table ignored (the port keeps no bucket table)",
              file=sys.stderr, flush=True)
    return warm


def parse_shapes(text: str) -> list[tuple[int, int, int]]:
    """Parse ``"8x4x96,16x8x160"`` into ``[(B, F, L), ...]``; empty -> []."""
    shapes = []
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        dims = part.lower().split("x")
        if len(dims) != 3:
            raise ValueError(f"bad warmup shape {part!r} (want BxFxL)")
        b, f, l = (int(d) for d in dims)
        if b < 1 or f < 1 or l < 1:
            raise ValueError(f"bad warmup shape {part!r} (dims must be >= 1)")
        shapes.append((b, f, l))
    return shapes


def _warm_batch(b: int, f: int, l: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 5, (b, f, l), dtype=np.uint8)
    quals = rng.integers(0, 41, (b, f, l), dtype=np.uint8)
    sizes = np.full(b, f, dtype=np.int32)
    return bases, quals, sizes


def warm_shapes(shapes, budget_s: float | None = None, device="cuda") -> int:
    """Launch B1's dense form once per ``(B, F, L)`` bucket on ``device``
    (the first launch builds the kernel library, as ``ops.cuda_lib``
    does at first use).  Returns how many shapes ran.  ``budget_s``
    bounds the total warmup wall — a supervised restart must get back to
    accepting (journal-replayed) jobs quickly; skipped shapes cost
    nothing later (the port compiles nothing per shape).  A failed launch
    raises."""
    import torch

    from consensuscruncher_tpu_torch.device import resolve_device
    from consensuscruncher_tpu_torch.ops import consensus_vote

    dev = resolve_device(device)
    config = consensus_vote.ConsensusConfig()
    done = 0
    t0 = time.monotonic()
    for i, (b, f, l) in enumerate(shapes):
        if budget_s is not None and time.monotonic() - t0 >= budget_s:
            print(f"WARNING: warmup budget {budget_s:g}s spent after {done} "
                  f"shape(s); skipping {len(shapes) - i} remaining",
                  file=sys.stderr, flush=True)
            break
        bases, quals, sizes = _warm_batch(b, f, l)
        out_b, out_q = consensus_vote.consensus_batch(
            torch.from_numpy(bases).to(dev), torch.from_numpy(quals).to(dev),
            torch.from_numpy(sizes), config)
        out_b.cpu(), out_q.cpu()
        done += 1
    return done
