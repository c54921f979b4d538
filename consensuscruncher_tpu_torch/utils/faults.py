"""Fault-injection registry + bounded retry: the port's chaos harness.

Port of ``consensuscruncher_tpu/utils/faults.py``.  Every recovery path
guards a named **site**, and a test arms the site through the
environment, so the exact production code path (including CLI
subprocesses and daemons, which inherit the environment) fires the fault.

Spec (env, so it crosses fork/exec boundaries for free):

  CCT_FAULTS       comma-separated ``site=kind[@times][:arg]`` directives,
                   e.g. ``serve.worker=exit@1,serve.dispatch=fail@2``
  CCT_FAULTS_DIR   optional ledger directory.  When set, each site's firing
                   budget is counted ACROSS PROCESSES via O_CREAT|O_EXCL
                   marker files — "exactly one daemon dies, once" is
                   expressible even though a restarted daemon sees the
                   same spec.  Without it, budgets are per-process.

Kinds:

  fail    raise :class:`FaultError` (arg unused)
  exit    ``os._exit(arg or 137)`` — an un-catchable process death
  kill    ``os.kill(self, SIG<arg or TERM>)`` — real signal delivery
  stall   ``time.sleep(arg or 0.05)`` — slow-I/O; correctness must hold

Sites wired in the port (grep for ``fault_point``/``faults.hook``):

  align.barrier        prestart-barrier warm-up failure -> serial fallback
  align.barrier_worker worker-side prestart stall -> real barrier timeout
  align.pool_worker    fork-pool worker death -> re-fork once, then serial
  subprocess.bwa       external aligner failure -> bounded retry + backoff
  serve.accept         daemon connection accept/handling -> error reply
  serve.dispatch       scheduler gang dispatch -> jobs run solo
  serve.worker         per-job worker execution -> retry via --resume
  serve.journal_write  journal append -> submit refused, nothing half-acked
  serve.journal_replay corrupt journal record -> skip + log, rest recovers
  serve.sigterm        shutdown handler -> immediate stop, replay recovers
  serve.shed           deadline admission check -> forced shed
  serve.poison         deterministic poison job -> budget-capped re-runs,
                       then durable quarantine; honest jobs unharmed
  serve.enospc         journal append ENOSPC -> cache evicts, retry once,
                       then read-only brownout (polls still served)
  serve.oom            memory watermark breach -> shed scavenger -> batch
                       -> interactive; running jobs never killed
  serve.cache          result-cache lookup/insert -> miss, recompute
  route.member_down    router forward hits a dead member -> ring failover
  route.steal          steal decision fails -> job stays on its home node
  route.resubmit       failover resubmission fails -> retried, idempotent
  route.router_down    standby's probe of the active router -> takeover
  route.adopt          journal adoption fails -> no tombstone, sweep retries
  route.view_publish   ring-view publish fails -> membership stays live
  route.fence          worker epoch admission -> stale router demoted

The reference's BGZF, mesh, stage and streaming sites come with the port
of their readers (the port's mesh never degrades, so it has no
``mesh.unavailable``).  Stdlib-only and import-cheap.
"""

from __future__ import annotations

import os
import signal
import sys
import time


class FaultError(RuntimeError):
    """An injected failure.  Never raised outside fault-injection runs."""


class FaultInjector:
    """Parsed CCT_FAULTS spec + firing budgets (see module docstring)."""

    def __init__(self, spec: str, ledger_dir: str | None = None):
        self.spec = spec
        self.ledger_dir = ledger_dir
        self._sites: dict[str, dict] = {}
        self._fired: dict[str, int] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part or "=" not in part:
                continue
            site, rhs = part.split("=", 1)
            arg = None
            if ":" in rhs:
                rhs, arg = rhs.split(":", 1)
            times = 1
            if "@" in rhs:
                rhs, t = rhs.split("@", 1)
                times = int(t)
            self._sites[site.strip()] = {
                "kind": rhs.strip(), "times": times, "arg": arg,
            }

    def armed(self, site: str) -> bool:
        return site in self._sites

    def fire(self, site: str) -> dict | None:
        """Consume one firing of ``site``.  Returns the directive while the
        budget lasts, then None forever — this is what makes "fail twice,
        then succeed" expressible."""
        d = self._sites.get(site)
        if d is None:
            return None
        if self.ledger_dir:
            # Cross-process budget: claiming marker file i < times wins
            # exactly once across every process sharing the ledger.
            os.makedirs(self.ledger_dir, exist_ok=True)
            for i in range(d["times"]):
                marker = os.path.join(self.ledger_dir, f"{site}.{i}")
                try:
                    fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                except FileExistsError:
                    continue
                os.close(fd)
                return d
            return None
        n = self._fired.get(site, 0)
        if n >= d["times"]:
            return None
        self._fired[site] = n + 1
        return d


_cached: tuple[str, str | None, FaultInjector] | None = None


def get() -> FaultInjector:
    """The process-wide injector, re-parsed whenever the env spec changes
    (so monkeypatch.setenv works without reload, and forked children that
    mutate nothing share the parent's budgets)."""
    global _cached
    spec = os.environ.get("CCT_FAULTS", "")
    ledger = os.environ.get("CCT_FAULTS_DIR") or None
    if _cached is None or _cached[0] != spec or _cached[1] != ledger:
        _cached = (spec, ledger, FaultInjector(spec, ledger))
    return _cached[2]


def _perform(site: str, d: dict) -> None:
    kind = d["kind"]
    if kind == "fail":
        raise FaultError(f"injected fault at {site}")
    if kind == "exit":
        os._exit(int(d["arg"] or 137))
    if kind == "kill":
        sig = getattr(signal, d["arg"]) if d["arg"] else signal.SIGTERM
        os.kill(os.getpid(), sig)
        # Default-disposition signals deliver asynchronously: block so the
        # code after the injection point never runs in the dying process.
        time.sleep(30)
        return
    if kind == "stall":
        time.sleep(float(d["arg"] or 0.05))
        return
    raise ValueError(f"unknown fault kind {kind!r} at site {site!r}")


def _notify(site: str, d: dict) -> None:
    """Every fault firing, whichever entry point consumed it, lands in the
    observability layer: a trace event
    and a flight-recorder entry.  Fatal kinds dump the ring before the
    process disappears — the only post-mortem an ``exit``/``kill`` leaves.
    Lazy import: faults must stay import-cheap for io/ and tools/ parents,
    and obs must be free to import faults-adjacent utils."""
    kind = d.get("kind", "?")
    try:
        from consensuscruncher_tpu_torch.obs import flight, trace
        trace.event("fault.fire", site=site, kind=kind)
        flight.record("fault", site=site, fault=kind)
        if kind in ("exit", "kill"):
            flight.dump(reason=f"fault-{kind}:{site}")
    except Exception as e:  # never let observability break the injection
        print(f"WARNING: fault notify failed at {site}: {e}",
              file=sys.stderr, flush=True)


def _consume(site: str) -> dict | None:
    """Shared budget-consume path for :func:`fault_point` and :func:`fire`:
    returns the armed directive (after notifying observers) or None."""
    inj = get()
    if not inj._sites:
        return None
    d = inj.fire(site)
    if d is not None:
        _notify(site, d)
    return d


def fault_point(site: str) -> None:
    """The one call a subsystem plants at an injection point.  No-op (two
    dict lookups) unless CCT_FAULTS arms ``site``."""
    d = _consume(site)
    if d is not None:
        _perform(site, d)


def fire(site: str) -> dict | None:
    """Like :func:`fault_point` but returns the directive instead of acting,
    for call sites that express the fault in their own vocabulary (e.g. the
    watcher swapping in a known-failing command)."""
    return _consume(site)


def hook(site: str):
    """Resolve an injection point ONCE for a hot loop: None when ``site``
    is not armed (so the loop pays a single ``if`` per iteration), else a
    zero-arg callable that consumes budget and performs the directive."""
    if not get().armed(site):
        return None
    return lambda: fault_point(site)


def retrying(fn, *, site: str, attempts: int = 3, base_delay: float | None = None,
             max_delay: float = 30.0, retriable: tuple = (Exception,),
             describe: str | None = None, sleep=time.sleep):
    """Call ``fn()`` with bounded retry + exponential backoff.

    ``site`` doubles as the injection point: an armed ``site=fail@k``
    directive makes the first k attempts fail synthetically, which is how
    tests express "flake twice, then succeed" against the real retry loop.
    ``base_delay=None`` reads CCT_RETRY_BASE_S (default 0.5 s; tests set it
    to ~0 so backoff is exercised without wall-clock cost).
    """
    if base_delay is None:
        base_delay = float(os.environ.get("CCT_RETRY_BASE_S", "0.5"))
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    catch = tuple(retriable) + (FaultError,)
    for attempt in range(attempts):
        try:
            fault_point(site)
            return fn()
        except catch as e:
            if attempt + 1 >= attempts:
                raise
            delay = min(max_delay, base_delay * (2.0 ** attempt))
            print(f"WARNING: {describe or site} failed ({e}); "
                  f"retry {attempt + 2}/{attempts} in {delay:.1f}s",
                  file=sys.stderr, flush=True)
            sleep(delay)
    raise AssertionError("unreachable")


def backoff_delay(attempt: int, base: float, cap: float) -> float:
    """Exponential backoff schedule shared by the retry loops: delay before
    attempt ``attempt+1`` after ``attempt`` failures (attempt >= 1)."""
    return min(cap, base * (2.0 ** max(0, attempt - 1)))
