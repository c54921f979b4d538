"""Daemon supervisor: restart a crashed serve daemon with capped backoff.

``ConsensusCruncher.py serve --supervise`` runs this loop instead of the
daemon itself: the daemon runs as a child process, and when it dies with
a nonzero status (segfault, OOM-kill, kill -9, an injected ``exit``
fault) the supervisor respawns it after a capped exponential backoff.
Combined with the write-ahead journal this closes the crash loop: the
restarted daemon replays the journal, re-enqueues every acknowledged job,
and finishes each one byte-identically through ``--resume`` — a client
polling by idempotency key never notices.

Policy:

- exit 0 means the daemon drained cleanly (SIGTERM path): the supervisor
  exits 0 too, it never restarts a *deliberate* shutdown;
- SIGTERM/SIGINT to the supervisor forward to the child and stop the
  restart loop (the child drains, both exit);
- crashes restart after ``backoff_delay(streak, base, cap)``; a child
  that stayed up ``healthy_s`` before dying resets the streak, so a
  once-a-day crasher restarts promptly while a crash loop backs off;
- ``max_restarts`` (``CCT_SERVE_MAX_RESTARTS``, default 10) bounds the
  total restarts, after which the supervisor gives up with the child's
  last exit status — a persistent crash must page a human, not spin.

The loop is dependency-injectable (``spawn``/``sleep``) so the unit tests
drive it with fake children and virtual time.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

from consensuscruncher_tpu_torch.obs import flight as obs_flight
from consensuscruncher_tpu_torch.utils import faults

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

# a spawned child of the port's CLI, as a user would start it: ``python
# -m`` with the package's root first on its import path (see child_env);
# the soak, the chaos conductor and the load generator start their
# daemons, routers and workers so
BOOT = ("-m", "consensuscruncher_tpu_torch.cli")


def child_env(env: dict | None = None) -> dict:
    """``env`` (default: this process's environment) with the package's
    root prepended to ``PYTHONPATH``, so a :data:`BOOT` child imports this
    checkout's package whatever its cwd."""
    env = dict(os.environ if env is None else env)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _REPO_ROOT + (os.pathsep + path if path else "")
    return env


def child_command(serve_argv: list[str]) -> list[str]:
    """The daemon child's command line: this interpreter running the CLI
    with ``serve_argv`` (the serve subcommand flags, minus --supervise).
    sys.path bootstrap instead of ``-m``: the package is run from a repo
    checkout, not necessarily an installed distribution."""
    boot = (
        "import sys; "
        f"sys.path.insert(0, {_REPO_ROOT!r}); "
        "from consensuscruncher_tpu_torch.cli import main; "
        "sys.exit(main(sys.argv[1:]))"
    )
    return [sys.executable, "-c", boot] + list(serve_argv)


def run_supervised(cmd: list[str], max_restarts: int | None = None,
                   base_s: float | None = None, cap_s: float = 30.0,
                   healthy_s: float = 30.0, spawn=None, sleep=time.sleep) -> int:
    """Spawn ``cmd`` and keep it alive (see module docstring).  Returns the
    final exit status: 0 for a clean drain, the child's last nonzero
    status once the restart budget is exhausted."""
    if spawn is None:
        spawn = subprocess.Popen
    if max_restarts is None:
        max_restarts = int(os.environ.get("CCT_SERVE_MAX_RESTARTS", "10"))
    if base_s is None:
        base_s = float(os.environ.get("CCT_RETRY_BASE_S", "0.5"))

    state = {"child": None, "stop": False}

    def _forward(signum, _frame):
        state["stop"] = True
        child = state["child"]
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signal.SIGTERM)  # child drains + exits 0
            except OSError:
                pass

    previous = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, _forward)
    except ValueError:
        pass  # not the main thread (embedded/test use): no forwarding

    try:
        restarts = 0
        streak = 0
        while True:
            started = time.monotonic()
            child = state["child"] = spawn(cmd)
            print(f"supervise: daemon started (pid {child.pid})",
                  file=sys.stderr, flush=True)
            rc = child.wait()
            alive_s = time.monotonic() - started
            if state["stop"] or rc == 0:
                print(f"supervise: daemon exited rc={rc}; done",
                      file=sys.stderr, flush=True)
                return int(rc or 0)
            if alive_s >= healthy_s:
                streak = 0  # a long healthy run restarts from the base delay
            restarts += 1
            streak += 1
            # the supervisor outlives the crash, so its flight ring is the
            # one place the restart history accumulates across child lives
            obs_flight.record("child_crash", rc=int(rc),
                              alive_s=round(alive_s, 3), restart=restarts)
            if restarts > max_restarts:
                print(f"ERROR: daemon crashed rc={rc}; restart budget "
                      f"({max_restarts}) exhausted — giving up",
                      file=sys.stderr, flush=True)
                return int(rc) if rc else 1
            delay = faults.backoff_delay(streak, base_s, cap_s)
            print(f"WARNING: daemon crashed rc={rc} after {alive_s:.1f}s; "
                  f"restart {restarts}/{max_restarts} in {delay:.2f}s "
                  "(journal replay will re-enqueue accepted jobs)",
                  file=sys.stderr, flush=True)
            sleep(delay)
    finally:
        for sig, handler in previous.items():
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass
