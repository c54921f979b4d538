"""Fail-fast card probe for user-facing entry points.

Port of ``consensuscruncher_tpu/utils/backend_probe.py``: the serve daemon
touches its device once, before it binds its socket, under a watchdog.  A
card whose driver hangs on context creation makes the probe print an
actionable message and hard-exit instead of hanging silently; a card
that is missing or fails raises ``SystemExit`` naming ``--device cpu``.
The probe never degrades to the CPU: the CPU runs only when the caller
asks for it (``--device cpu``).

The port has no counterpart of the reference's ``jax_platform_for`` or
``force_cpu_platform``: torch picks its device per tensor, so there is no
process-wide platform to pin, and the silicon a stage ran on is the
stage's device itself (:func:`record_backend` writes it under
``backend``, as every port stage does; ``jax_backend`` stays absent from
the stats and null in the metrics sidecars).  The JAX package's
``backend`` values (``consensus --backend``, a config key, a stage
entry's ``--backend``) read through :func:`device_of_backend`: ``tpu``
and ``xla_cpu`` as the port's device, ``cpu`` and ``reference`` as the
host backends (:data:`HOST_BACKENDS`), which run on the host alone and
never touch torch's devices.
"""

from __future__ import annotations

import os
import sys
import threading


def _default_timeout_s() -> float:
    try:
        return float(os.environ.get("CCT_CUDA_INIT_TIMEOUT", 120.0))
    except ValueError:
        print(f"WARNING: ignoring non-numeric CCT_CUDA_INIT_TIMEOUT="
              f"{os.environ['CCT_CUDA_INIT_TIMEOUT']!r}; using 120s", file=sys.stderr)
        return 120.0


def record_backend(stats, device) -> None:
    """Record what a stage ran on under the ``backend`` stats key: its
    device (``cuda`` or ``cpu``) or its host backend (``cpu`` or
    ``reference``, as the JAX package records them).  The golden digests
    drop every line naming it."""
    stats.set("backend", getattr(device, "type", str(device)))


def ensure_backend(device, timeout_s: float | None = None):
    """Resolve ``device`` (``cuda``, the default, or ``cpu``) and, for the
    card, create its context now under a watchdog.  Returns the resolved
    ``torch.device``.

    - no CUDA      -> ``SystemExit`` with ``device.resolve_device``'s message
    - init hangs   -> message + ``os._exit(3)`` (a hung driver call cannot
      be interrupted from Python)
    - init raises  -> ``SystemExit`` with the cause and ``--device cpu``
    - init works   -> the context is warm for the stages
    """
    from consensuscruncher_tpu_torch.device import resolve_device

    try:
        dev = resolve_device(device)
    except RuntimeError as exc:
        raise SystemExit(str(exc)) from None
    if dev.type != "cuda":
        return dev
    if timeout_s is None:
        timeout_s = _default_timeout_s()
    done = threading.Event()

    def watchdog() -> None:
        if not done.wait(timeout_s):
            print(f"ERROR: CUDA context creation did not complete within {timeout_s:.0f}s "
                  "— the card looks unavailable.\n"
                  "  workaround: --device cpu (the kernels' plain PyTorch versions)\n"
                  "  or wait longer: CCT_CUDA_INIT_TIMEOUT=<seconds>",
                  file=sys.stderr, flush=True)
            os._exit(3)

    threading.Thread(target=watchdog, daemon=True).start()
    try:
        import torch

        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    except Exception as exc:
        raise SystemExit(f"CUDA card unavailable ({exc}) — re-run with --device cpu") from None
    finally:
        done.set()
    return dev


# The JAX package's ``backend`` values that name a device of the port.
_BACKEND_DEVICE = {"tpu": "cuda", "xla_cpu": "cpu"}

# The JAX package's host backends, which the port runs as they are: ``cpu``
# the numpy twin (columnar decode, ``consensus_maker_numpy``), ``reference``
# the object path (per-read decode, ``grouping.stream_families``, the
# per-position Counter vote).  Both rescue and pair on the host with numpy.
HOST_BACKENDS = ("cpu", "reference")


def check_host_backend(backend: str) -> None:
    """Refuse a stage's ``backend`` keyword that names no host backend."""
    if backend not in HOST_BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected 'cpu' or 'reference')")


def device_of_backend(backend: str | None,
                      flag: str | None = None) -> tuple[str | None, str | None]:
    """``(device, host backend)`` for a JAX ``backend`` value; ``(None,
    None)`` when unset.  ``tpu`` (the device kernels) is the card,
    ``xla_cpu`` (the same kernels on the CPU) the CPU; ``cpu`` and
    ``reference`` are host backends (:data:`HOST_BACKENDS`) and name no
    device.  Any other value exits.  ``flag`` names the option that gave
    the value (``--backend``); None means a config.ini key."""
    if backend in (None, ""):
        return None, None
    if backend in _BACKEND_DEVICE:
        return _BACKEND_DEVICE[backend], None
    if backend in HOST_BACKENDS:
        return None, backend
    where = f"{flag} " if flag else "config backend = "
    raise SystemExit(f"{where}{backend!r}: expected tpu, xla_cpu, cpu or reference "
                     "(or set device = cuda|cpu)")


def entry_device(device: str | None, backend: str | None):
    """``(device, host backend)`` of a standalone stage entry (``python -m
    consensuscruncher_tpu_torch.stages.<stage>``): ``--device`` wins, and
    is resolved by :func:`ensure_backend` (the card, or a ``SystemExit``
    without one); else the reference's ``--backend`` (default ``tpu``)
    reads through :func:`device_of_backend`, and ``cpu`` runs the stage's
    host backend, touching no device: ``(None, "cpu")``."""
    if not device:
        device, host = device_of_backend(backend, flag="--backend")
        if host is not None:
            return None, host
    return ensure_backend(device), None
