"""Soak the serve daemon's durability loop: submit, kill -9, recover.

Port of the JAX package's ``tools/serve_soak.py``: the same flags,
defaults, messages and exit codes, against the port's daemon.  The
harness drives the REAL crash-recovery stack end to end:

  1. start a daemon child under :func:`supervisor.run_supervised` (the
     ``serve --supervise`` loop) with a write-ahead ``--journal``;
  2. submit ``--jobs`` consensus jobs against ``test/data/sample.bam``;
  3. after a seeded random delay, ``kill -9`` the daemon (pid taken from
     its own ``healthz`` reply) — the supervisor restarts it, the journal
     replays, and every acknowledged job finishes via ``--resume``;
  4. poll every job to completion BY IDEMPOTENCY KEY (ids don't survive a
     restart, keys do) and verify each output tree against the frozen
     ``test/golden.json`` digests — byte-identity, not just success;
  5. SIGTERM the daemon: it drains, exits 0, and the supervisor returns 0.

Exit status 0 means every accepted job completed byte-identical to an
uninterrupted run.  The daemon child is the port's CLI (``python -m
consensuscruncher_tpu_torch.cli serve ... --device D``: :data:`BOOT` and
:func:`child_env` of ``serve/supervisor.py``, with the package's root first
on its import path); ``--device`` is ``cuda``
(the card) by default and ``cpu`` only when asked.  The child's output
goes to ``<workdir>/daemon.log``.  A child that cannot serve (no card for
``--device cuda``) exits before its socket appears, and the soak then
fails naming the child's exit code and the log's tail: nothing falls back
to the CPU.

  python -m consensuscruncher_tpu_torch.utils.serve_soak --jobs 4 \\
      --workdir /tmp/soak --seed 7
  python -m consensuscruncher_tpu_torch.utils.serve_soak --jobs 3 \\
      --workdir /tmp/soak --seed 7 --kill-after 0.3 --device cpu

A kill that lands after every job finished replays nothing and still
exits 0 (the reference's contract): choose ``--kill-after`` shorter than
the jobs' wall to test a replay.

This harness soaks ONE supervised daemon.  The fleet-level randomized
soak — router failover, journal adoption, membership churn — lives in
``utils/chaos_conductor.py``, which drives a whole HA fleet through a
seeded fault schedule and imports this module's :func:`job_spec` /
:func:`check_golden` / :data:`BOOT` / :func:`child_env` helpers (single
source of truth for the golden contract).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

from consensuscruncher_tpu_torch.serve import supervisor
from consensuscruncher_tpu_torch.serve.client import ServeClient
from consensuscruncher_tpu_torch.serve.supervisor import BOOT, child_env

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# seconds a spawned child may take to bind its socket (a card process
# imports torch and loads the kernel library first)
_READY_S = 300.0


def job_spec(output: str) -> dict:
    return {"input": os.path.join(_ROOT, "test", "data", "sample.bam"),
            "output": output, "name": "golden", "cutoff": 0.7,
            "qualscore": 0, "scorrect": True, "max_mismatch": 0,
            "bdelim": "|", "compress_level": 6}


def check_golden(base: str, golden: dict) -> list[str]:
    """Digest-compare one job's output tree; returns mismatch descriptions."""
    from consensuscruncher_tpu_torch.utils.digest import canonical_bam_digest, text_digest

    problems = []
    for rel, want in golden["consensus"].items():
        path = os.path.join(base, rel)
        if not os.path.exists(path):
            problems.append(f"missing {rel}")
            continue
        got = (canonical_bam_digest(path) if rel.endswith(".bam")
               else text_digest(path))
        if got != want:
            problems.append(f"{rel}: digest {got} != golden {want}")
    return problems


class _Stopped(Exception):
    """Raised into the supervisor loop once the soak has given up on a
    daemon that cannot serve: the loop ends instead of respawning it."""


def _log_tail(path: str) -> str:
    with open(path, "rb") as fh:
        return fh.read()[-2000:].decode("utf-8", "replace")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--workdir", required=True,
                    help="scratch directory for socket/journal/outputs")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the kill-point jitter (reproducible chaos)")
    ap.add_argument("--kill-after", type=float, default=5.0,
                    help="mean seconds between the submits and the kill -9")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-job completion deadline")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="forwarded to the daemon: where its jobs vote "
                         "(default cuda: the card; the daemon exits "
                         "without one). cpu runs the kernels' plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    sock = os.path.join(args.workdir, "soak.sock")
    journal = os.path.join(args.workdir, "soak.journal")
    log_path = os.path.join(args.workdir, "daemon.log")
    golden = json.load(open(os.path.join(_ROOT, "test", "golden.json")))
    if os.path.exists(sock):
        os.unlink(sock)  # a previous soak's: readiness waits for this one's

    daemon_cmd = [sys.executable, *BOOT,
                  "serve", "--socket", sock, "--journal", journal,
                  "--gang_size", "1", "--queue_bound", str(max(8, args.jobs)),
                  "--device", args.device, "--drain_s", "120"]
    sup: dict = {}
    stop = threading.Event()
    children: list = []

    def _spawn(cmd):
        if stop.is_set():
            raise _Stopped()
        with open(log_path, "ab") as log:
            child = subprocess.Popen(cmd, env=child_env(), stdout=log,
                                     stderr=subprocess.STDOUT)
        children.append(child)
        return child

    def _supervise():
        # non-main thread: run_supervised skips signal forwarding; the
        # harness delivers signals straight to the daemon pid instead
        try:
            sup["rc"] = supervisor.run_supervised(
                daemon_cmd, max_restarts=5, base_s=0.2, cap_s=2.0,
                spawn=_spawn)
        except _Stopped:
            sup["rc"] = None

    sup_thread = threading.Thread(target=_supervise, name="soak-supervisor")
    sup_thread.start()
    client = ServeClient(sock, retries=200, retry_base_s=0.25)

    try:
        # the first child must bind its socket before anything is asked of
        # it: one that exits first cannot serve (no card for --device
        # cuda, a bad flag), and respawning it would change nothing
        deadline = time.monotonic() + _READY_S
        while not os.path.exists(sock):
            code = children[0].poll() if children else None
            if code is not None or time.monotonic() > deadline:
                stop.set()
                what = (f"exited {code}" if code is not None
                        else f"bound no socket in {_READY_S:g}s")
                print(f"soak: FAIL the daemon {what} before serving (log: "
                      f"{log_path}):\n{_log_tail(log_path)}",
                      file=sys.stderr, flush=True)
                return 1
            time.sleep(0.1)
        pid = client.healthz()["pid"]
        print(f"soak: daemon serving (pid {pid}); submitting "
              f"{args.jobs} job(s)", flush=True)
        subs = []
        for i in range(args.jobs):
            out = os.path.join(args.workdir, f"job{i}")
            subs.append((i, out, client.submit_full(job_spec(out))))

        rng = random.Random(args.seed)
        delay = args.kill_after * rng.uniform(0.5, 1.5)
        print(f"soak: kill -9 in {delay:.1f}s (seed {args.seed})", flush=True)
        time.sleep(delay)
        pid = client.healthz()["pid"]
        os.kill(pid, signal.SIGKILL)
        print(f"soak: killed daemon pid {pid}; supervisor restarts, "
              "journal replays", flush=True)

        failures = []
        for i, out, sub in subs:
            job = client.result(key=sub["key"], timeout=args.timeout)
            if job["state"] != "done":
                failures.append(f"job{i}: {job['state']} ({job.get('error')})")
                continue
            failures += [f"job{i}: {p}"
                         for p in check_golden(os.path.join(out, "golden"),
                                                golden)]
        replayed = client.metrics()["cumulative"]["jobs_replayed"]
        print(f"soak: {args.jobs} job(s) finished, {replayed} replayed "
              "from the journal", flush=True)

        # The kill-9 post-mortem contract: the restarted daemon's journal
        # replay is an anomaly (requeued jobs, no clean drain marker), so it
        # must have dumped the flight ring next to the journal — and every
        # dump must be complete JSON (commit_file means no torn dumps).
        dumps = sorted(glob.glob(os.path.join(args.workdir, "flight-*.json")))
        reasons = []
        for path in dumps:
            try:
                doc = json.load(open(path))
            except ValueError as e:
                failures.append(f"flight dump {path} unparseable: {e}")
                continue
            if not isinstance(doc.get("events"), list) or \
                    not isinstance(doc.get("reason"), str):
                failures.append(f"flight dump {path} missing events/reason")
            else:
                reasons.append(doc["reason"])
        if replayed and "journal-replay" not in reasons:
            failures.append(
                f"{replayed} job(s) replayed but no journal-replay flight "
                f"dump under {args.workdir} (found: {reasons or 'none'})")
        print(f"soak: {len(dumps)} flight dump(s): {reasons}", flush=True)

        # clean shutdown: the daemon drains, exits 0, supervisor follows
        os.kill(client.healthz()["pid"], signal.SIGTERM)
        sup_thread.join(timeout=180)
        if sup_thread.is_alive():
            failures.append("supervisor did not exit after SIGTERM")
        elif sup.get("rc") != 0:
            failures.append(f"supervisor exited rc={sup.get('rc')}")

        if failures:
            for f in failures:
                print(f"soak: FAIL {f}", file=sys.stderr, flush=True)
            return 1
        print("soak: OK — every accepted job byte-identical to golden",
              flush=True)
        return 0
    finally:
        stop.set()
        if sup_thread.is_alive():
            # last-resort teardown so a failed run never leaks the daemon
            for child in children:
                if child.poll() is None:
                    try:
                        child.send_signal(signal.SIGTERM)
                    except OSError:
                        pass
            sup_thread.join(timeout=60)


if __name__ == "__main__":
    sys.exit(main())
