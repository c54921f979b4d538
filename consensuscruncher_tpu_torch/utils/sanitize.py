"""Opt-in runtime sanitizers (``CCT_SANITIZE=1``).

Port of ``consensuscruncher_tpu/utils/sanitize.py``.  It catches what only
execution can: a host<->card synchronisation sneaking into a hot stage
loop (an ``.item()``, a blocking ``.cpu()`` or a pageable upload arriving
through a call chain nobody reviewed), and lock-order inversions that
only show under real thread interleavings.  Three pieces:

- :func:`guarded_stage` — wraps the SSCS/DCS device loops in
  ``torch.cuda.set_sync_debug_mode("error")``, converting any synchronising
  CUDA call made there into an actionable :class:`StageTransferError`.
  The stage's own batch uploads and downloads are the sanctioned boundary
  and run inside :func:`allow_transfer`.
- :func:`allow_transfer` — the sanctioned-region escape hatch.
- :func:`tracked_lock` / :func:`tracked_condition` — drop-in lock wrappers
  recording per-thread acquisition stacks; under ``CCT_SANITIZE=1`` an
  acquisition that inverts a previously-seen order raises
  :class:`LockOrderError` at the faulty acquire, not as a production hang.

What the stage guard covers, and what it cannot.  The JAX package's guard
is a context-local transfer guard plus a thread-local shim, so it sees
only the guarded thread.  Torch's sync debug mode is one process-wide
setting: while any guarded stage is open (on any thread) it is
``"error"``, and while any :func:`allow_transfer` region is open (on any
thread) it is back at the mode that was set before the first guard.  So:

- a sync on ANOTHER thread during a guarded stage (a serve request
  thread, a writer thread) raises too — which is why the guard is armed
  only under ``CCT_SANITIZE=1``, never in production;
- a sync on the guarded thread while another thread holds an
  ``allow_transfer`` region is not seen;
- only the card synchronises: a stage on the CPU arms no mode, and there
  the :func:`sync_probe` fault stands in for the sync it plants.

The previous mode is saved when the first guard opens and restored when
the last one closes.  Import-cheap (torch is imported on first use).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time


class StageTransferError(RuntimeError):
    """A host<->device sync happened inside a guarded stage."""


class LockOrderError(RuntimeError):
    """Two locks were acquired in opposite orders on different paths."""


def enabled() -> bool:
    """Read dynamically so tests can flip CCT_SANITIZE via monkeypatch."""
    return os.environ.get("CCT_SANITIZE", "") == "1"


# --------------------------------------------------------------- stage guard

_tls = threading.local()


def _depth() -> int:
    return getattr(_tls, "depth", 0)


def _allow_depth() -> int:
    return getattr(_tls, "allow", 0)


# process-wide: torch's sync debug mode is one setting for every thread
_mode_lock = threading.Lock()
_guards = 0          # guarded stages open on the card, all threads
_allows = 0          # allow_transfer regions open while a guard is, all threads
_saved_mode = None   # the mode before the first guard opened


def _set_mode_locked() -> None:
    import torch

    torch.cuda.set_sync_debug_mode("error" if _guards and not _allows else _saved_mode)


def _blocked(what: str) -> StageTransferError:
    stage = getattr(_tls, "stage", "?")
    return StageTransferError(
        f"[CCT_SANITIZE] {what} inside guarded stage '{stage}' — a mid-stage "
        "host sync serialises the card's work behind the host. Move the sync "
        "to the stage boundary, or wrap a sanctioned region in "
        "sanitize.allow_transfer(reason).")


def _is_sync_error(exc: BaseException) -> bool:
    return isinstance(exc, RuntimeError) and "synchronizing" in str(exc).lower()


@contextlib.contextmanager
def guarded_stage(name: str, device=None):
    """No-op unless ``CCT_SANITIZE=1``; then a synchronising CUDA call in
    the body raises :class:`StageTransferError` naming the stage and the
    fix.  ``device``: the stage's device; the card's sync debug mode is
    armed only for a CUDA device (a CPU stage never synchronises, and
    arming would open a CUDA context)."""
    if not enabled():
        yield
        return
    global _guards, _saved_mode
    on_card = getattr(device, "type", device) == "cuda"
    _tls.depth = _depth() + 1
    prev_stage = getattr(_tls, "stage", None)
    _tls.stage = name
    if on_card:
        import torch

        with _mode_lock:
            if _guards == 0:
                _saved_mode = torch.cuda.get_sync_debug_mode()
            _guards += 1
            _set_mode_locked()
    try:
        yield
    except StageTransferError:
        raise
    except Exception as exc:
        if _is_sync_error(exc):
            raise _blocked(f"synchronising CUDA call ({exc})") from exc
        raise
    finally:
        _tls.depth = _depth() - 1
        _tls.stage = prev_stage
        if on_card:
            with _mode_lock:
                _guards -= 1
                _set_mode_locked()


@contextlib.contextmanager
def allow_transfer(reason: str):
    """Sanctioned transfer region inside a guarded stage (the stage's batch
    upload, vote and download).  ``reason`` is mandatory."""
    if not reason or not reason.strip():
        raise ValueError("allow_transfer() requires a non-empty reason")
    if not enabled():
        yield
        return
    global _allows
    _tls.allow = _allow_depth() + 1
    with _mode_lock:
        armed = _guards > 0
        if armed:
            _allows += 1
            _set_mode_locked()
    try:
        yield
    finally:
        _tls.allow = _allow_depth() - 1
        if armed:
            with _mode_lock:
                _allows -= 1
                _set_mode_locked()


def sync_probe(site: str, device=None) -> None:
    """Chaos hook proving the guard catches mid-stage syncs: when the fault
    site ``site`` is armed (``CCT_FAULTS=<site>=fail``), plant a real
    ``.item()`` of a tensor on ``device`` right here — under
    ``CCT_SANITIZE=1`` inside a guarded stage on the card, torch's sync
    debug mode turns it into :class:`StageTransferError`; on the CPU,
    where nothing synchronises, the guarded thread's probe raises it for
    the sync it stands for.  Outside a guard it is a harmless sync.
    Unarmed cost: two dict lookups."""
    yield_point(site)
    from . import faults

    if faults.fire(site) is None:
        return
    import torch

    dev = torch.device("cpu" if device is None else device)
    guarded = enabled() and _depth() > 0 and _allow_depth() == 0
    if dev.type != "cuda":
        if guarded:
            raise _blocked(f"planted sync at '{site}'")
        return
    try:
        torch.zeros(1, device=dev).item()
    except RuntimeError as exc:
        if _is_sync_error(exc):
            raise _blocked(f"planted .item() at '{site}' ({exc})") from exc
        raise


# --------------------------------------------------------- interleave hooks
#
# The deterministic model checker (``utils/interleave.py``, run over the
# serve plane by ``utils/model_check.py``) drives real threads through
# one-at-a-time cooperative scheduling.  Its yield points
# are exactly the operations this module already wraps: TrackedLock /
# TrackedCondition acquire+release, ``sync_probe`` sites, and explicit
# ``yield_point`` calls on the serve plane's protocol boundaries.  The
# hook is process-global but must ignore threads it does not manage —
# that filtering is the hook object's job, so unmanaged production
# threads pay only a None check.

_interleave_hook = None


def set_interleave_hook(hook) -> None:
    """Install (or clear, with ``None``) the cooperative scheduler hook.
    The hook sees ``before_acquire(name, lock)`` / ``after_release(name,
    lock)`` around every tracked lock operation, ``on_wait(name, cond)``
    before a condition wait, and ``yield_point(tag)`` at explicit sites."""
    global _interleave_hook
    _interleave_hook = hook


def yield_point(tag: str) -> None:
    """A schedule point for the model checker; no-op outside model runs.
    Placed where the serve protocol's ordering matters but no lock edge
    exists (journal replay reads, ack boundaries, view scans)."""
    h = _interleave_hook
    if h is not None:
        h.yield_point(tag)


# ------------------------------------------------------------ lock tracking

#: (earlier lock, later lock) -> "file-free" first-seen marker.  Guarded by
#: _edges_lock; held only for dict ops, never while user locks are taken.
_edges: dict[tuple[str, str], bool] = {}
_edges_lock = threading.Lock()


def _held() -> list[str]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _note_acquire(name: str, check: bool = True) -> None:
    held = _held()
    if check and enabled():
        with _edges_lock:
            for h in held:
                if h == name:
                    continue
                _edges[(h, name)] = True
                if (name, h) in _edges:
                    raise LockOrderError(
                        f"[CCT_SANITIZE] lock order inversion: acquiring "
                        f"'{name}' while holding '{h}', but the opposite "
                        f"order '{name}' -> '{h}' was taken earlier — "
                        "pick one global order for these locks."
                    )
    held.append(name)


def _note_release(name: str) -> None:
    held = _held()
    if name in held:
        # remove the innermost occurrence (out-of-order release is legal
        # for plain Locks, rare in practice)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break


def reset_lock_tracking() -> None:
    """Test hook: forget every recorded ordering edge."""
    with _edges_lock:
        _edges.clear()


# -------------------------------------------------------- contention ledger
#
# Opt-in (``CCT_LOCK_LEDGER=1``) hold/wait timing per named lock, feeding
# the critpath antagonist view and the ``lock_wait_us`` / ``lock_hold_us``
# / ``lock_waits`` labeled counters the scheduler composes into its metrics
# doc at read time.  Off by default: the production fast path pays one
# cached env check per acquire.  Contention is detected with a free
# non-blocking acquire first — only the acquires that actually block pay
# the clock, so uncontended hot paths stay unmeasured and cheap.

#: name -> [wait_us, hold_us, waits, acquires]; guarded by _ledger_lock.
_ledger: dict[str, list[int]] = {}
#: name -> thread name currently holding the lock (antagonist attribution).
_holders: dict[str, str] = {}
_ledger_lock = threading.Lock()
_ledger_env: tuple[str, bool] = ("\x00", False)


def ledger_enabled() -> bool:
    """Cached on the raw env string so monkeypatch.setenv invalidates."""
    global _ledger_env
    raw = os.environ.get("CCT_LOCK_LEDGER", "")
    if raw != _ledger_env[0]:
        _ledger_env = (raw, raw == "1")
    return _ledger_env[1]


def _ledger_note(name: str, wait_us: int = 0, hold_us: int = 0,
                 contended: bool = False, acquired: bool = False) -> None:
    with _ledger_lock:
        row = _ledger.get(name)
        if row is None:
            row = _ledger[name] = [0, 0, 0, 0]
        row[0] += wait_us
        row[1] += hold_us
        if contended:
            row[2] += 1
        if acquired:
            row[3] += 1


def _holder_set(name: str) -> None:
    with _ledger_lock:
        _holders[name] = threading.current_thread().name


def _holder_clear(name: str) -> None:
    with _ledger_lock:
        _holders.pop(name, None)


def ledger_snapshot() -> dict[str, dict[str, int]]:
    """Totals per lock name since process start (or :func:`reset_ledger`)."""
    with _ledger_lock:
        return {
            name: {"wait_us": row[0], "hold_us": row[1],
                   "waits": row[2], "acquires": row[3]}
            for name, row in sorted(_ledger.items())
        }


def current_holders() -> dict[str, str]:
    """lock name -> holder thread name, for the antagonist view."""
    with _ledger_lock:
        return dict(_holders)


def reset_ledger() -> None:
    """Test hook: zero every ledger row and forget holders."""
    with _ledger_lock:
        _ledger.clear()
        _holders.clear()


class TrackedLock:
    """Drop-in ``threading.Lock`` recording acquisition order per thread."""

    def __init__(self, name: str, factory=threading.Lock):
        self._name = name
        self._lock = factory()
        self._acq_t = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        h = _interleave_hook
        if h is not None:
            h.before_acquire(self._name, self)
        _note_acquire(self._name)
        if ledger_enabled():
            ok = self._lock.acquire(False)
            if not ok and blocking:
                t0 = time.monotonic_ns()
                ok = self._lock.acquire(True, timeout)
                _ledger_note(self._name, contended=True, acquired=ok,
                             wait_us=(time.monotonic_ns() - t0) // 1000)
            elif ok:
                _ledger_note(self._name, acquired=True)
            if ok:
                self._acq_t = time.monotonic_ns()
                _holder_set(self._name)
        else:
            ok = self._lock.acquire(blocking, timeout)
        if not ok:
            _note_release(self._name)
        return ok

    def release(self) -> None:
        if self._acq_t:
            _ledger_note(self._name,
                         hold_us=(time.monotonic_ns() - self._acq_t) // 1000)
            self._acq_t = 0
            _holder_clear(self._name)
        self._lock.release()
        _note_release(self._name)
        h = _interleave_hook
        if h is not None:
            h.after_release(self._name, self)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class TrackedCondition:
    """Drop-in ``threading.Condition`` with the same order tracking.
    ``wait`` pops the condition from the held stack for its release window
    and re-pushes (without re-checking) on wake."""

    def __init__(self, name: str):
        self._name = name
        self._cond = threading.Condition()
        self._acq_t = 0

    def acquire(self, *args) -> bool:
        h = _interleave_hook
        if h is not None:
            h.before_acquire(self._name, self)
        _note_acquire(self._name)
        if ledger_enabled():
            ok = self._cond.acquire(False)
            if not ok and (not args or args[0]):
                t0 = time.monotonic_ns()
                ok = self._cond.acquire(*args)
                _ledger_note(self._name, contended=True, acquired=ok,
                             wait_us=(time.monotonic_ns() - t0) // 1000)
            elif ok:
                _ledger_note(self._name, acquired=True)
            if ok:
                self._acq_t = time.monotonic_ns()
                _holder_set(self._name)
            return ok
        return self._cond.acquire(*args)

    def release(self) -> None:
        self._close_hold()
        self._cond.release()
        _note_release(self._name)
        h = _interleave_hook
        if h is not None:
            h.after_release(self._name, self)

    def _close_hold(self) -> None:
        if self._acq_t:
            _ledger_note(self._name,
                         hold_us=(time.monotonic_ns() - self._acq_t) // 1000)
            self._acq_t = 0
            _holder_clear(self._name)

    def _reopen_hold(self) -> None:
        # Woken from cond.wait holding the lock again; the parked interval
        # was idle, not contention, so it lands in neither wait nor hold.
        if ledger_enabled():
            self._acq_t = time.monotonic_ns()
            _holder_set(self._name)

    def wait(self, timeout: float | None = None) -> bool:
        h = _interleave_hook
        if h is not None:
            h.on_wait(self._name, self)
        _note_release(self._name)
        self._close_hold()
        try:
            return self._cond.wait(timeout)
        finally:
            _note_acquire(self._name, check=False)
            self._reopen_hold()

    def wait_for(self, predicate, timeout: float | None = None):
        h = _interleave_hook
        if h is not None:
            h.on_wait(self._name, self)
        _note_release(self._name)
        self._close_hold()
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            _note_acquire(self._name, check=False)
            self._reopen_hold()

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def tracked_lock(name: str) -> TrackedLock:
    """A named lock whose acquisition order is asserted under
    ``CCT_SANITIZE=1`` (always safe to use; passthrough cost otherwise)."""
    return TrackedLock(name)


def tracked_condition(name: str) -> TrackedCondition:
    return TrackedCondition(name)
