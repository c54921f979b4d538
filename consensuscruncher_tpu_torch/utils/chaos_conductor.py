"""Seeded randomized fault-schedule soak for the HA serve fleet.

Port of the JAX package's ``tools/chaos_conductor.py``: the same flags,
defaults, schedule, events, invariants, messages and exit codes, against
the port's fleet, plus ``--device cuda|cpu`` (default ``cuda``: the
card).  Every worker is the port's CLI (``python -m
consensuscruncher_tpu_torch.cli serve ... --device D``); the routers and
this process are clients and open no CUDA context.  On the card the
kernel library is built once, before the fleet boots, and every worker
(respawns included) loads it from that build directory
(``--compile_cache``), so no spawn runs ``nvcc``.  Without a card,
``--device cuda`` fails before anything is spawned: nothing falls back
to the CPU.

The conductor boots a WHOLE fleet — N journaled workers, an active
router and a standby sharing an epoch-numbered ring-view document — and
drives it through a seeded random schedule of faults:

  submit              a consensus job through the router pair
  kill_worker         kill -9 a worker (its journal replays on restart)
  restart_worker      bring a killed worker back on the same journal
  kill_active_router  kill -9 whichever router the ring view says is
                      active; the standby must take over by epoch bump
  restart_router      bring the dead router back as the new standby
  perm_kill_worker    kill -9 a worker FOR GOOD; the active router must
                      adopt its journal (resubmit + tombstone)
  zombie_return       restart the permanently-killed worker on its
                      tombstoned journal; it must drop the adopted jobs
  add_member          grow the ring via the member_add op
  decommission_member kill + adopt + member_remove the grown member
  arm_fault           arm a route.*/serve.* fault site (CCT_FAULTS) on
                      the next respawned router/worker
  poison_submit       submit a deterministically crashing job (the fleet
                      is armed with ``serve.poison=exit`` and a fleet
                      retry budget of 3): every dispatch kills its
                      worker, the conductor plays supervisor restarting
                      it on the same journal, and crash attribution must
                      blame + QUARANTINE the key within the budget while
                      honest jobs sharing the fleet stay unharmed
  disk_full           restart a worker with ``serve.enospc`` armed: its
                      journal appends raise ENOSPC, the daemon must
                      answer ``brownout`` refusals (read-only, polls
                      still served) instead of dying, then clear the
                      brownout and serve again once appends succeed
  status_sweep        poll a sample of acknowledged jobs by key

With ``--netchaos`` the whole fleet is additionally spawned under the
deterministic wire-fault layer (``utils/netchaos.py``): every process
watches one spec file the conductor rewrites live, and four more events
enter the schedule:

  partition_worker        drop a worker off the network both ways (the
                          process stays up); the routers must ride out
                          the dark member and the ring must serve again
                          once the link heals
  asym_partition_routers  partition standby->active ONLY: the standby
                          cannot see the active and must take over by
                          epoch bump while the active is still alive —
                          the fence protocol has to keep the zombie
                          harmless (epochs monotone, no acked job lost)
  flap_link               partition/heal the active-router->worker link
                          3-5 times in quick succession (timeout/retry
                          churn, no stable failure for health to latch)
  corrupt_frames          flip a seeded byte in the next N frames from
                          the conductor's client to each router; the crc
                          envelope must catch every one (router
                          ``wire_crc_errors`` grows), the client resends,
                          and no corrupted frame is ever acted on

After EVERY event the invariants are re-checked:

  * no acknowledged job is lost (every key still resolves, none failed);
  * the ring-view epoch is monotone (strictly increases across events
    that change the view — takeover, membership);
  * each live router's cumulative counters are monotone;
  * trace completeness (``utils/trace_check.py``): every journal agrees
    on each key's trace_id, every trace's span tree is one connected
    component across the kill/steal/adoption hops, and a journal-proven
    terminal job has a durable trace-terminal event — the fleet runs
    with ``CCT_TRACE=1`` and shards under ``<workdir>/traces``.

At the end every dead-but-not-permanent worker is restarted, every
acknowledged job is driven to ``done``, and every output tree is
digest-compared against the frozen ``test/golden.json`` — byte
identity, not just success.  The poison key must end ``quarantined``
with its journaled suspect lineage never exceeding the fleet retry
budget.  Exit 0 means all invariants held.

  python -m consensuscruncher_tpu_torch.utils.chaos_conductor \\
      --workdir /tmp/chaos --seed 7 --events 30
  python -m consensuscruncher_tpu_torch.utils.chaos_conductor \\
      --workdir /tmp/chaos --smoke
  python -m consensuscruncher_tpu_torch.utils.chaos_conductor \\
      --workdir /tmp/chaos --smoke --netchaos --workers 2 --device cpu

Deterministic given ``--seed`` (modulo OS scheduling).  ``--smoke`` is
the fixed-seed short leg: fewer events, but the structural ones
(failover, adoption, zombie, membership, poison, disk-full) are always in
the schedule.  Shares :func:`serve_soak.job_spec` /
:func:`serve_soak.check_golden` / :data:`serve_soak.BOOT` /
:func:`serve_soak.child_env` with the single-daemon soak so there is one
source of truth for the golden contract.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import signal
import subprocess
import sys
import time

from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.serve.client import (
    JobQuarantined,
    ServeClient,
    ServeClientError,
)
from consensuscruncher_tpu_torch.utils import trace_check
from consensuscruncher_tpu_torch.utils.serve_soak import (
    _ROOT,
    BOOT,
    check_golden,
    child_env,
    job_spec,
)

WORKER_FAULTS = ("serve.worker=fail@1", "serve.dispatch=fail@1",
                 "serve.cache=fail@1")
ROUTER_FAULTS = ("route.member_down=fail@1", "route.resubmit=fail@1",
                 "route.steal=fail@1", "route.adopt=fail@1")
# every worker spawn arms the poison site (it only fires for jobs whose
# NAME contains "poison", so honest jobs never see it) and the whole
# fleet runs under one small retry budget so the poison_submit event's
# kill/restart loop is bounded.  3 (the production default) rather than
# 2: honest jobs share the budget, and this schedule kill -9s workers on
# purpose — a tighter cap could blame an honest job the conductor itself
# crashed twice mid-flight.
POISON_FAULT = "serve.poison=exit@99"
FLEET_ATTEMPT_BUDGET = 3


def read_ring_view(path: str) -> dict | None:
    """Highest-epoch record of the ring-view doc (same torn-tail-tolerant
    contract as serve.router.RingView.load, re-implemented here so the
    conductor parent never reads the view through the router's code)."""
    try:
        raw = open(path, "rb").read()
    except OSError:
        return None
    best = None
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict) and "epoch" in doc:
            if best is None or int(doc["epoch"]) > int(best["epoch"]):
                best = doc
    return best


def journal_tombstoned(path: str) -> bool:
    """True once the journal carries an ``adopted`` marker record."""
    try:
        raw = open(path, "rb").read()
    except OSError:
        return False
    for line in raw.split(b"\n"):
        if b'"adopted"' not in line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and rec.get("rec") == "marker" \
                and rec.get("kind") == "adopted":
            return True
    return False


class Conductor:
    def __init__(self, workdir: str, seed: int, workers: int = 3,
                 max_unique_jobs: int = 6, job_timeout_s: float = 600.0,
                 netchaos: bool = False, device: str = "cuda"):
        from consensuscruncher_tpu_torch.device import resolve_device

        # before any file or process exists: no card, no fleet
        self.device = resolve_device(device).type
        # the workers' shared kernel build directory (boot sets it on the card)
        self.build_dir: str | None = None
        self.workdir = os.path.abspath(workdir)
        self.rng = random.Random(seed)
        self.seed = seed
        self.job_timeout_s = float(job_timeout_s)
        self.max_unique_jobs = int(max_unique_jobs)
        self.logdir = os.path.join(self.workdir, "logs")
        os.makedirs(self.logdir, exist_ok=True)
        # every spawned process flushes spans here; the shards are what
        # the per-event trace-completeness check reads — kill -9 victims
        # included, since the ack/terminal flush points precede the acks
        self.trace_dir = os.path.join(self.workdir, "traces")
        os.makedirs(self.trace_dir, exist_ok=True)
        self.ring_view = os.path.join(self.workdir, "ring.view")
        self.golden = json.load(
            open(os.path.join(_ROOT, "test", "golden.json")))
        self.workers: dict[str, dict] = {}
        for i in range(workers):
            name = f"w{i}"
            self.workers[name] = {
                "sock": os.path.join(self.workdir, f"{name}.sock"),
                "journal": os.path.join(self.workdir, f"{name}.journal"),
                "proc": None, "alive": False, "permanent": False,
                "in_fleet": True, "original": True,
            }
        self.routers: dict[str, dict] = {
            rid: {"sock": os.path.join(self.workdir, f"{rid}.sock"),
                  "proc": None, "alive": False}
            for rid in ("r0", "r1")
        }
        self.acked: list[dict] = []       # {"key", "out", "spec"}
        self.poison: dict | None = None   # {"key", "out"} once submitted
        self.brownouts_seen = 0
        self.quarantines_seen = 0
        self.last_epoch = 0
        self.takeovers_seen = 0
        self.adoptions_seen = 0
        self.metrics_base: dict[str, dict] = {}
        self.next_worker_fault: str | None = None
        self.next_router_fault: str | None = None
        self.violations: list[str] = []
        self.netchaos = bool(netchaos)
        self.netchaos_spec = os.path.join(self.workdir, "netchaos.spec")
        self.net_rules: list[str] = []
        self.partitions_seen = 0
        self.asym_partitions_seen = 0
        self.flaps_seen = 0
        self.wire_crc_seen = 0
        if self.netchaos:
            # the whole fleet — this process's clients included — watches
            # one spec file; events partition/heal links by rewriting it
            self._write_netchaos([])
            os.environ["CCT_NETCHAOS"] = "@" + self.netchaos_spec
            os.environ["CCT_NETCHAOS_NODE"] = "client"
        # both front doors; a standby's busy refusal makes this rotate
        self.client = ServeClient(
            [r["sock"] for r in self.routers.values()],
            retries=60, retry_base_s=0.1)
        self.check_client = ServeClient(
            [r["sock"] for r in self.routers.values()],
            retries=6, retry_base_s=0.1)

    # ------------------------------------------------------------ process

    def _log(self, msg: str) -> None:
        print(f"chaos: {msg}", flush=True)

    def _violate(self, msg: str) -> None:
        self.violations.append(msg)
        print(f"chaos: VIOLATION {msg}", file=sys.stderr, flush=True)

    def _write_netchaos(self, rules: list) -> None:
        """Atomically rewrite the fleet-wide netchaos spec (the @file the
        whole fleet re-reads per connection).  An empty list heals every
        link."""
        self.net_rules = list(rules)
        text = ";".join([f"seed={self.seed}"] + self.net_rules) + "\n"
        tmp = self.netchaos_spec + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(text)
        os.replace(tmp, self.netchaos_spec)
        if self.netchaos:
            self._log("netchaos: "
                      + ("; ".join(self.net_rules) or "all links healed"))

    def _popen(self, tag: str, argv: list, fault: str | None) -> subprocess.Popen:
        env = child_env()
        env.pop("CCT_FAULTS", None)
        env.pop("CCT_NETCHAOS", None)
        env.pop("CCT_NETCHAOS_NODE", None)
        env["CCT_TRACE"] = "1"
        env["CCT_TRACE_DIR"] = self.trace_dir
        if self.netchaos:
            env["CCT_NETCHAOS"] = "@" + self.netchaos_spec
            env["CCT_NETCHAOS_NODE"] = tag
        # one fleet-wide retry budget (workers gate dispatches, routers
        # gate resubmits) so the poison event converges to quarantine
        env["CCT_SERVE_MAX_FLEET_ATTEMPTS"] = str(FLEET_ATTEMPT_BUDGET)
        if fault:
            env["CCT_FAULTS"] = fault
            self._log(f"  (spawning {tag} with CCT_FAULTS={fault})")
        log = open(os.path.join(self.logdir, f"{tag}.log"), "ab")
        return subprocess.Popen(argv, env=env, stdout=log, stderr=log)

    def _spawn_worker(self, name: str) -> None:
        w = self.workers[name]
        if os.path.exists(w["sock"]):
            os.unlink(w["sock"])
        argv = [sys.executable, *BOOT, "serve",
                "--socket", w["sock"], "--node", name,
                "--journal", w["journal"], "--gang_size", "1",
                "--queue_bound", "32", "--device", self.device,
                "--drain_s", "60"]
        if self.build_dir:
            argv += ["--compile_cache", self.build_dir]
        fault = POISON_FAULT
        if self.next_worker_fault:
            fault = f"{fault},{self.next_worker_fault}"
        w["proc"] = self._popen(name, argv, fault)
        self.next_worker_fault = None
        w["alive"] = True
        w["permanent"] = False

    def _member_flags(self) -> list:
        members = ",".join(
            f"{n}={w['sock']}" for n, w in self.workers.items()
            if w["in_fleet"])
        journals = ",".join(
            f"{n}={w['journal']}" for n, w in self.workers.items())
        return ["--members", members, "--journals", journals]

    def _spawn_router(self, rid: str, standby: bool) -> None:
        r = self.routers[rid]
        if os.path.exists(r["sock"]):
            os.unlink(r["sock"])
        argv = [sys.executable, *BOOT, "route",
                "--socket", r["sock"], "--router_id", rid,
                "--ring_view", self.ring_view,
                "--standby", str(standby),
                "--takeover_after", "2", "--health_interval_s", "0.5",
                "--down_after", "2", "--adopt_after_s", "3",
                ] + self._member_flags()
        r["proc"] = self._popen(rid, argv, self.next_router_fault)
        self.next_router_fault = None
        r["alive"] = True
        self.metrics_base.pop(rid, None)

    def _wait_socket(self, path: str, what: str, timeout: float = 240.0) -> None:
        deadline = time.monotonic() + timeout
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise RuntimeError(f"{what} never came up ({path} missing)")
            time.sleep(0.2)

    def _kill9(self, proc: subprocess.Popen, what: str) -> None:
        try:
            proc.send_signal(signal.SIGKILL)
        except OSError:
            pass
        proc.wait(timeout=30)
        self._log(f"kill -9 {what} (pid {proc.pid})")

    def boot(self) -> None:
        self._log(f"booting fleet under {self.workdir} (seed {self.seed})")
        if self.device == "cuda":
            # one build before any worker starts (nvcc only, no CUDA
            # context here): every spawn and respawn loads this library
            from consensuscruncher_tpu_torch.ops import cuda_lib

            library = cuda_lib.build("consensus_vote")
            self.build_dir = os.path.dirname(library)
            self._log(f"kernel library at {library}")
        for name in self.workers:
            self._spawn_worker(name)
        for name, w in self.workers.items():
            self._wait_socket(w["sock"], f"worker {name}")
        self._spawn_router("r0", standby=False)
        self._wait_socket(self.routers["r0"]["sock"], "router r0")
        # active must have published before the standby starts probing,
        # or the standby could win the empty-view takeover race at boot
        deadline = time.monotonic() + 120.0
        while True:
            doc = read_ring_view(self.ring_view)
            if doc and doc.get("router") == "r0":
                break
            if time.monotonic() > deadline:
                raise RuntimeError("r0 never published the ring view")
            time.sleep(0.2)
        self._spawn_router("r1", standby=True)
        self._wait_socket(self.routers["r1"]["sock"], "router r1")
        self.last_epoch = int(doc["epoch"])
        self._log(f"fleet up: {len(self.workers)} workers, r0 active "
                  f"(epoch {self.last_epoch}), r1 standby")

    # ------------------------------------------------------------- events

    def ev_submit(self) -> None:
        n = len({a["out"] for a in self.acked})
        if n < self.max_unique_jobs:
            out = os.path.join(self.workdir, "jobs", f"job{n}")
        else:  # re-submit an existing spec: must dedup to the same key
            out = self.rng.choice(self.acked)["out"]
        spec = job_spec(out)
        dup = [a for a in self.acked if a["out"] == out]
        # a logical re-submit continues the original ack's trace context
        # (the wire-propagation contract for clients that retry a known
        # job) — otherwise a router that lost its placement cache in a
        # takeover would mint a fresh trace for the same dedup key
        sub = self.client.submit_full(
            spec, trace=dup[0].get("trace") if dup else None)
        if dup and dup[0]["key"] != sub["key"]:
            self._violate(f"resubmit of {out} got key {sub['key']} != "
                          f"original {dup[0]['key']}")
        self.acked.append({"key": sub["key"], "out": out, "spec": spec,
                           "trace": sub.get("trace")
                           or (dup[0].get("trace") if dup else None)})
        self._log(f"submit -> key {sub['key']} on {sub.get('node')}"
                  + (" (duplicate)" if sub.get("duplicate") else ""))

    def _poll_status(self, key: str, deadline_s: float = 90.0) -> dict | None:
        deadline = time.monotonic() + deadline_s
        last: Exception | None = None
        while time.monotonic() < deadline:
            try:
                return self.check_client.status(key=key)
            except JobQuarantined as e:
                # a poll that answers the quarantine IS a resolution
                return {"state": "quarantined",
                        "error": e.reply.get("reason") or str(e)}
            except Exception as e:
                last = e
                time.sleep(0.5)
        self._violate(f"acked key {key} unresolvable after "
                      f"{deadline_s:.0f}s: {last}")
        return None

    def ev_status_sweep(self, sample: int = 4) -> None:
        picks = self.rng.sample(self.acked, min(sample, len(self.acked)))
        for rec in picks:
            job = self._poll_status(rec["key"])
            if job is None:
                continue
            if job["state"] == "failed":
                self._violate(f"acked key {rec['key']} FAILED: "
                              f"{job.get('error')}")
        if picks:
            self._log(f"status sweep: {len(picks)} key(s) resolvable")

    def _live_workers(self) -> list:
        return [n for n, w in self.workers.items()
                if w["alive"] and w["in_fleet"]]

    def ev_kill_worker(self) -> None:
        live = self._live_workers()
        if len(live) < 2:
            self._log("kill_worker skipped (only one worker alive)")
            return
        name = self.rng.choice(live)
        self.workers[name]["alive"] = False
        self._kill9(self.workers[name]["proc"], f"worker {name}")

    def ev_restart_worker(self) -> None:
        dead = [n for n, w in self.workers.items()
                if not w["alive"] and not w["permanent"] and w["in_fleet"]]
        if not dead:
            self._log("restart_worker skipped (none dead)")
            return
        name = self.rng.choice(dead)
        self._spawn_worker(name)
        self._wait_socket(self.workers[name]["sock"], f"worker {name}")
        self._log(f"worker {name} restarted (journal replays)")

    def ev_kill_active_router(self) -> None:
        doc = read_ring_view(self.ring_view)
        if not doc:
            self._violate("no ring view document at kill_active_router")
            return
        rid = str(doc.get("router"))
        if rid not in self.routers or not self.routers[rid]["alive"]:
            self._log(f"kill_active_router skipped ({rid} not alive)")
            return
        standby_alive = any(r["alive"] for k, r in self.routers.items()
                            if k != rid)
        if not standby_alive:
            self._log("kill_active_router skipped (no standby to fail to)")
            return
        old_epoch = int(doc["epoch"])
        self.routers[rid]["alive"] = False
        self.metrics_base.pop(rid, None)
        self._kill9(self.routers[rid]["proc"], f"active router {rid}")
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            doc = read_ring_view(self.ring_view)
            if doc and doc.get("router") != rid \
                    and int(doc["epoch"]) > old_epoch:
                self.takeovers_seen += 1
                self._log(f"takeover: {doc['router']} is active at epoch "
                          f"{doc['epoch']} (was {rid}@{old_epoch})")
                return
            time.sleep(0.25)
        self._violate(f"no takeover within 60s of killing active {rid}")

    def ev_restart_router(self) -> None:
        dead = [rid for rid, r in self.routers.items() if not r["alive"]]
        if not dead:
            self._log("restart_router skipped (both routers alive)")
            return
        rid = dead[0]
        self._spawn_router(rid, standby=True)
        self._wait_socket(self.routers[rid]["sock"], f"router {rid}")
        self._log(f"router {rid} restarted as standby")

    def ev_perm_kill_worker(self) -> None:
        live = [n for n in self._live_workers()
                if self.workers[n]["original"]]
        if len(live) < 2:
            self._log("perm_kill_worker skipped (too few workers alive)")
            return
        name = self.rng.choice(live)
        w = self.workers[name]
        w["alive"] = False
        w["permanent"] = True
        self._kill9(w["proc"], f"worker {name} (PERMANENT)")
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if journal_tombstoned(w["journal"]):
                self.adoptions_seen += 1
                self._log(f"journal of {name} adopted (tombstone present)")
                return
            time.sleep(0.5)
        self._violate(f"journal of {name} not adopted within 120s")

    def ev_zombie_return(self) -> None:
        perm = [n for n, w in self.workers.items()
                if w["permanent"] and w["in_fleet"]]
        if not perm:
            self._log("zombie_return skipped (no permanently dead worker)")
            return
        name = perm[0]
        w = self.workers[name]
        if not journal_tombstoned(w["journal"]):
            self._log(f"zombie_return skipped ({name} not yet adopted)")
            return
        self._spawn_worker(name)  # clears the permanent flag
        self._wait_socket(w["sock"], f"zombie {name}")
        try:
            m = ServeClient(w["sock"], retries=30,
                            retry_base_s=0.1).metrics()["cumulative"]
            self._log(f"zombie {name} rejoined; dropped "
                      f"{m.get('fencing_rejections', 0)} adopted job(s) "
                      "at replay")
        except Exception as e:
            self._violate(f"zombie {name} unreachable after restart: {e}")

    def ev_add_member(self) -> None:
        name = f"w{len(self.workers)}"
        self.workers[name] = {
            "sock": os.path.join(self.workdir, f"{name}.sock"),
            "journal": os.path.join(self.workdir, f"{name}.journal"),
            "proc": None, "alive": False, "permanent": False,
            "in_fleet": False, "original": False,
        }
        self._spawn_worker(name)
        self._wait_socket(self.workers[name]["sock"], f"worker {name}")
        self.client.request({"op": "member_add", "name": name,
                             "address": self.workers[name]["sock"],
                             "journal": self.workers[name]["journal"]},
                            timeout=60.0)
        self.workers[name]["in_fleet"] = True
        self._log(f"member {name} added to the ring")

    def ev_decommission_member(self) -> None:
        added = [n for n, w in self.workers.items()
                 if not w["original"] and w["in_fleet"]]
        if not added:
            self._log("decommission skipped (no added member)")
            return
        name = added[0]
        w = self.workers[name]
        # decommission's adopt step resubmits the member's jobs to ring
        # successors — there must BE one, and the fleet must keep at
        # least one live member for the rest of the schedule's submits
        if not [n for n in self._live_workers() if n != name]:
            self._log(f"decommission skipped ({name} is the last live "
                      "member; nobody could adopt its jobs)")
            return
        if w["alive"]:
            w["alive"] = False
            self._kill9(w["proc"], f"member {name} (decommission)")
        self.client.request({"op": "adopt", "node": name, "force": True},
                            timeout=300.0)
        self.client.request({"op": "member_remove", "name": name},
                            timeout=60.0)
        w["in_fleet"] = False
        w["permanent"] = True
        self._log(f"member {name} decommissioned (adopt + remove)")

    def ev_arm_fault(self) -> None:
        if self.rng.random() < 0.5:
            self.next_worker_fault = self.rng.choice(WORKER_FAULTS)
            self._log(f"armed {self.next_worker_fault} for the next "
                      "worker spawn")
        else:
            self.next_router_fault = self.rng.choice(ROUTER_FAULTS)
            self._log(f"armed {self.next_router_fault} for the next "
                      "router spawn")

    def _reap_poison_victims(self) -> None:
        """The conductor IS the fleet's supervisor: any worker that died
        without the conductor killing it (the armed ``serve.poison`` exit)
        is restarted on its own journal, which is exactly what makes the
        suspect lineage grow toward the quarantine verdict."""
        for name, w in self.workers.items():
            if w["alive"] and not w["permanent"] and w["in_fleet"] \
                    and w["proc"] is not None and w["proc"].poll() is not None:
                self._log(f"worker {name} died on its own "
                          f"(rc {w['proc'].returncode}, poison victim); "
                          "restarting on its journal")
                w["alive"] = False
                self._spawn_worker(name)
                self._wait_socket(w["sock"], f"worker {name}")

    def ev_poison_submit(self) -> None:
        if self.poison is not None:
            self._log("poison_submit skipped (poison key already placed)")
            return
        out = os.path.join(self.workdir, "jobs", "poison")
        spec = dict(job_spec(out), name="poison-pill")
        try:
            sub = self.client.submit_full(spec)
        except ServeClientError as e:
            self._violate(f"poison submit was not even acknowledged: {e}")
            return
        self.poison = {"key": sub["key"], "out": out}
        self._log(f"poison submit -> key {sub['key']} on {sub.get('node')} "
                  f"(budget {FLEET_ATTEMPT_BUDGET}); every dispatch will "
                  "kill its worker")
        deadline = time.monotonic() + 300.0
        state = None
        while time.monotonic() < deadline:
            self._reap_poison_victims()
            try:
                state = self.check_client.status(key=sub["key"])["state"]
            except JobQuarantined:
                state = "quarantined"
            except Exception:
                state = None
            if state == "quarantined":
                break
            time.sleep(0.5)
        self._reap_poison_victims()
        if state != "quarantined":
            self._violate(f"poison key {sub['key']} not quarantined within "
                          f"300s (last state {state!r})")
            return
        self.quarantines_seen += 1
        self._log(f"poison key {sub['key']} QUARANTINED; fleet lives on")

    def ev_disk_full(self) -> None:
        live = [n for n in self._live_workers()
                if self.workers[n]["original"]] or self._live_workers()
        if len(self._live_workers()) < 2:
            self._log("disk_full skipped (too few workers alive)")
            return
        name = self.rng.choice(live)
        w = self.workers[name]
        w["alive"] = False
        self._kill9(w["proc"], f"worker {name} (disk about to fill)")
        self.next_worker_fault = "serve.enospc=fail@2"
        self._spawn_worker(name)
        self._wait_socket(w["sock"], f"worker {name}")
        # talk to the browning-out worker directly with a non-retrying
        # client: each refusal must carry the brownout flag, and the
        # daemon must survive to accept the same spec once appends work
        probe = ServeClient(w["sock"], retries=0, retry_base_s=0.1)
        out = os.path.join(self.workdir, "jobs",
                           f"brownout{self.brownouts_seen}")
        refusals = 0
        sub = None
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            try:
                sub = probe.submit_full(job_spec(out))
                break
            except ServeClientError as e:
                if e.reply.get("brownout"):
                    refusals += 1
                elif not (e.reply.get("busy") or e.reply.get("transport")
                          or e.reply.get("shutdown")):
                    self._violate(f"disk_full: worker {name} answered a "
                                  f"non-brownout error: {e}")
                    return
            except OSError:
                pass  # still booting
            time.sleep(0.5)
        if sub is None:
            self._violate(f"worker {name} never recovered from the "
                          "ENOSPC brownout within 120s")
            return
        self.brownouts_seen += 1
        self.acked.append({"key": sub["key"], "out": out,
                           "spec": job_spec(out),
                           "trace": sub.get("trace")})
        # the 2 armed append failures may be consumed by replayed-job
        # dispatch records instead (post-admission failures brown out
        # silently: availability over durability), so the refusal count
        # is reported, not asserted — the hard invariant is that the
        # daemon LIVED through ENOSPC and serves again
        self._log(f"worker {name} refused {refusals} submit(s) in "
                  f"brownout, then accepted key {sub['key']} — disk "
                  "recovered, daemon never died")

    # ------------------------------------------------------ netchaos events

    def _router_wire_crc_errors(self) -> int:
        """Sum of ``wire_crc_errors`` over every reachable live router."""
        total = 0
        for rid, r in self.routers.items():
            if not r["alive"]:
                continue
            try:
                m = ServeClient(r["sock"], retries=2,
                                retry_base_s=0.1).metrics()["cumulative"]
            except Exception:
                continue
            total += int(m.get("wire_crc_errors", 0))
        return total

    def ev_partition_worker(self) -> None:
        live = self._live_workers()
        if len(live) < 2:
            self._log("partition_worker skipped (too few workers alive)")
            return
        name = self.rng.choice(live)
        self._write_netchaos([f"*<->{name}=partition"])
        # the fleet must keep answering while the member is dark; kept
        # short of the adoption timer — a partitioned worker is NOT dead,
        # and this event is about riding out the outage, not adopting
        try:
            self.check_client.request({"op": "healthz"}, timeout=30.0)
        except Exception as e:
            self._violate(f"fleet unhealthy while {name} partitioned: {e}")
        time.sleep(1.2)
        self._write_netchaos([])
        self.partitions_seen += 1
        self.ev_submit()  # the healed ring must place and ack again
        self._log(f"worker {name} partitioned both ways and healed; "
                  "fleet answered throughout")

    def ev_asym_partition_routers(self) -> None:
        doc = read_ring_view(self.ring_view)
        if not doc:
            self._violate("no ring view document at asym_partition_routers")
            return
        active = str(doc.get("router"))
        standby = "r1" if active == "r0" else "r0"
        if not (self.routers.get(active, {}).get("alive")
                and self.routers.get(standby, {}).get("alive")):
            self._log("asym_partition_routers skipped (need both routers "
                      "alive)")
            return
        old_epoch = int(doc["epoch"])
        # standby cannot see the active; the active (and the file-based
        # ring view) are otherwise untouched — the classic split-brain
        # trigger where the "dead" node is alive the whole time
        self._write_netchaos([f"{standby}->{active}=partition"])
        deadline = time.monotonic() + 60.0
        took = False
        while time.monotonic() < deadline:
            doc = read_ring_view(self.ring_view)
            if doc and doc.get("router") == standby \
                    and int(doc["epoch"]) > old_epoch:
                took = True
                break
            time.sleep(0.25)
        self._write_netchaos([])
        if not took:
            self._violate(f"standby {standby} did not take over within 60s "
                          f"of its asymmetric partition from {active}")
            return
        self.takeovers_seen += 1
        self.asym_partitions_seen += 1
        self._log(f"asym partition: {standby} took over at epoch "
                  f"{doc['epoch']} while {active} stayed alive (zombie "
                  "must now be fenced)")
        self.ev_submit()  # the pair must still ack with a zombie around

    def ev_flap_link(self) -> None:
        doc = read_ring_view(self.ring_view)
        rid = str(doc.get("router")) if doc else "r0"
        if rid not in self.routers or not self.routers[rid]["alive"]:
            self._log("flap_link skipped (no live active router)")
            return
        live = self._live_workers()
        if not live:
            self._log("flap_link skipped (no live worker)")
            return
        name = self.rng.choice(live)
        cycles = self.rng.randint(3, 5)
        for _ in range(cycles):
            self._write_netchaos([f"{rid}->{name}=partition"])
            time.sleep(self.rng.uniform(0.15, 0.35))
            self._write_netchaos([])
            time.sleep(self.rng.uniform(0.1, 0.25))
        self.flaps_seen += 1
        self._log(f"link {rid}->{name} flapped {cycles}x and healed")
        self.ev_status_sweep(sample=2)

    def ev_corrupt_frames(self) -> None:
        n = self.rng.randint(2, 5)
        before = self._router_wire_crc_errors()
        self._write_netchaos([f"client->r0=corrupt@{n}",
                              f"client->r1=corrupt@{n}"])
        try:
            # the corrupted submits must be caught by the crc envelope,
            # answered retryable, and resent clean — never acted on
            self.ev_submit()
        finally:
            self._write_netchaos([])
        after = self._router_wire_crc_errors()
        caught = after - before
        if caught > 0:
            self.wire_crc_seen += caught
            self._log(f"corrupt_frames: {caught} corrupted frame(s) caught "
                      f"by the wire crc (cumulative {after})")
        else:
            self._log("corrupt_frames: no crc catch observed this round "
                      "(frames may have fallen on a dead connection)")

    # --------------------------------------------------------- invariants

    def _journal_paths(self) -> list:
        return [w["journal"] for w in self.workers.values()
                if os.path.exists(w["journal"])]

    def _live_trace_groups(self) -> list:
        """Best-effort pull of every LIVE process's in-memory span ring
        over the wire (the ``{"op": "trace", "fleet": true}`` fan-out).
        Live rings matter: a surviving router's linking span may not have
        hit its on-disk shard yet, and checking shards alone would
        misread that unflushed edge as a disconnected component."""
        try:
            buffers = self.check_client.request(
                {"op": "trace", "fleet": True}, timeout=30.0)["trace"]
        except Exception:
            return []
        if isinstance(buffers, dict):
            buffers = [buffers]
        groups = []
        for buf in buffers or []:
            events = (buf or {}).get("events") or []
            node = (buf or {}).get("node")
            if node:
                for ev in events:
                    ev.setdefault("node", node)
            groups.append(events)
        return groups

    def check_trace(self, where: str) -> dict:
        """The fleet trace-completeness invariant, re-asserted after every
        event: all journals agree on each key's trace_id, every trace's
        span tree is one connected component (follows_from links stitch
        across kills/steals/adoptions), and journal-terminal implies a
        durable trace-terminal event.  Merges the flushed shards off
        ``CCT_TRACE_DIR`` (what a post-mortem would have) with the live
        fleet's in-memory rings (what a kill -9 would lose), deduped —
        the same merge ``cct trace fleet`` ships."""
        shard_events, _ = trace_check._load_events(self.trace_dir)
        groups = [shard_events] + self._live_trace_groups()
        merged = os.path.join(self.workdir, "trace_merged.json")
        obs_trace.merge_fleet_trace(groups, merged)
        summary = trace_check.fleet_summary(merged, self._journal_paths())
        for p in summary["problems"]:
            self._violate(f"[{where}] trace: {p}")
        return summary

    def check_invariants(self, where: str) -> None:
        doc = read_ring_view(self.ring_view)
        if doc is not None:
            epoch = int(doc["epoch"])
            if epoch < self.last_epoch:
                self._violate(f"[{where}] ring-view epoch went BACKWARD: "
                              f"{self.last_epoch} -> {epoch}")
            self.last_epoch = max(self.last_epoch, epoch)
        for rid, r in self.routers.items():
            if not r["alive"]:
                continue
            try:
                m = ServeClient(r["sock"], retries=2,
                                retry_base_s=0.1).metrics()["cumulative"]
            except Exception:
                continue  # mid-restart/busy: monotonicity rechecked later
            base = self.metrics_base.get(rid)
            if base:
                for k, v in base.items():
                    if m.get(k, 0) < v:
                        self._violate(f"[{where}] router {rid} counter "
                                      f"{k} went backward: {v} -> "
                                      f"{m.get(k, 0)}")
            self.metrics_base[rid] = dict(m)

    # ------------------------------------------------------------ drive

    def build_schedule(self, events: int) -> list:
        names = ["submit", "status_sweep", "kill_worker", "restart_worker",
                 "arm_fault"]
        weights = [3.0, 2.0, 1.5, 1.5, 1.0]
        sched = self.rng.choices(names, weights=weights, k=max(1, events))
        forced = [(0.20, "add_member"),
                  (0.30, "poison_submit"),
                  (0.35, "kill_active_router"),
                  (0.45, "restart_router"),
                  (0.55, "perm_kill_worker"),
                  (0.65, "disk_full"),
                  (0.75, "decommission_member"),
                  (0.85, "zombie_return")]
        if self.netchaos:
            # wire faults ride the same schedule: the worker partition
            # early (full fleet), the router-pair split after the pair is
            # whole again, frame corruption and flapping in between
            forced += [(0.10, "partition_worker"),
                       (0.25, "corrupt_frames"),
                       (0.50, "asym_partition_routers"),
                       (0.70, "flap_link"),
                       (0.90, "corrupt_frames")]
        for frac, name in forced:
            idx = int(frac * len(sched)) + self.rng.randint(-1, 1)
            sched.insert(max(0, min(len(sched), idx)), name)
        if sched[0] != "submit":  # something must be in flight from the start
            sched.insert(0, "submit")
        return sched

    def run(self, events: int) -> int:
        self.boot()
        schedule = self.build_schedule(events)
        self._log(f"schedule ({len(schedule)} events): "
                  + " ".join(schedule))
        handlers = {
            "submit": self.ev_submit,
            "status_sweep": self.ev_status_sweep,
            "kill_worker": self.ev_kill_worker,
            "restart_worker": self.ev_restart_worker,
            "kill_active_router": self.ev_kill_active_router,
            "restart_router": self.ev_restart_router,
            "perm_kill_worker": self.ev_perm_kill_worker,
            "zombie_return": self.ev_zombie_return,
            "add_member": self.ev_add_member,
            "decommission_member": self.ev_decommission_member,
            "arm_fault": self.ev_arm_fault,
            "poison_submit": self.ev_poison_submit,
            "disk_full": self.ev_disk_full,
            "partition_worker": self.ev_partition_worker,
            "asym_partition_routers": self.ev_asym_partition_routers,
            "flap_link": self.ev_flap_link,
            "corrupt_frames": self.ev_corrupt_frames,
        }
        try:
            for i, name in enumerate(schedule):
                self._log(f"--- event {i + 1}/{len(schedule)}: {name}")
                try:
                    handlers[name]()
                except Exception as e:
                    self._violate(f"event {name} raised: {e!r}")
                self.check_invariants(f"event {i + 1}:{name}")
                self.check_trace(f"event {i + 1}:{name}")
                time.sleep(self.rng.uniform(0.2, 1.0))
            return self.finish()
        finally:
            self.teardown()

    def check_poison(self) -> None:
        """The poison key must have ended quarantined — and the journals
        must prove its suspect lineage never exceeded the fleet retry
        budget, on ANY worker the routers may have resubmitted it to."""
        if self.poison is None:
            return
        key = self.poison["key"]
        job = self._poll_status(key)
        if job is not None and job["state"] != "quarantined":
            self._violate(f"poison key {key} ended {job['state']!r}, "
                          "not 'quarantined'")
        worst = 0
        for path in self._journal_paths():
            for line in open(path, "rb").read().split(b"\n"):
                if b'"suspect"' not in line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("rec") == "marker" \
                        and rec.get("kind") == "suspect" \
                        and rec.get("key") == key:
                    worst = max(worst, int(rec.get("attempt") or 0))
        if worst > FLEET_ATTEMPT_BUDGET:
            self._violate(f"poison key {key} reached journaled attempt "
                          f"{worst} > fleet budget {FLEET_ATTEMPT_BUDGET}")
        else:
            self._log(f"poison key {key}: worst journaled attempt {worst} "
                      f"<= budget {FLEET_ATTEMPT_BUDGET}, verdict "
                      "quarantined")

    def finish(self) -> int:
        self._log("schedule complete; draining every acknowledged job")
        if self.netchaos:
            self._write_netchaos([])  # every link healed before the drain
        self._reap_poison_victims()
        # revive every transiently-dead worker so its journal drains
        for name, w in self.workers.items():
            if not w["alive"] and not w["permanent"] and w["in_fleet"]:
                self._spawn_worker(name)
                self._wait_socket(w["sock"], f"worker {name}")
        if not any(r["alive"] for r in self.routers.values()):
            self._violate("no router alive at the end of the schedule")
            return self.report()
        outs = {}
        for rec in self.acked:
            outs.setdefault(rec["out"], rec["key"])
        for out, key in outs.items():
            deadline = time.monotonic() + self.job_timeout_s
            state = None
            while time.monotonic() < deadline:
                try:
                    job = self.check_client.status(key=key)
                except Exception:
                    time.sleep(1.0)
                    continue
                state = job["state"]
                if state in ("done", "failed"):
                    break
                time.sleep(1.0)
            if state != "done":
                self._violate(f"acked job {key} ({out}) ended {state!r}")
                continue
            problems = check_golden(os.path.join(out, "golden"), self.golden)
            for p in problems:
                self._violate(f"golden mismatch for {key} ({out}): {p}")
            if not problems:
                self._log(f"job {key} done, byte-identical goldens")
        if self.takeovers_seen < 1:
            self._violate("schedule finished without a router takeover")
        if self.adoptions_seen < 1:
            self._violate("schedule finished without a journal adoption")
        self.check_poison()
        if self.quarantines_seen < 1:
            self._violate("schedule finished without the poison "
                          "quarantine landing")
        if self.brownouts_seen < 1:
            self._violate("schedule finished without an ENOSPC brownout "
                          "recovery")
        if self.netchaos:
            if self.partitions_seen < 1:
                self._violate("netchaos schedule finished without a worker "
                              "partition")
            if self.asym_partitions_seen < 1:
                self._violate("netchaos schedule finished without an "
                              "asymmetric router-pair partition takeover")
            if self.wire_crc_seen < 1:
                self._violate("netchaos schedule finished without a single "
                              "wire_crc_errors catch — the corrupt frames "
                              "were never seen by the crc envelope")
        self.trace_summary = self.check_trace("finish")
        if self.trace_summary["spans"] <= 0:
            self._violate("no trace spans survived the schedule (fleet "
                          "was spawned with CCT_TRACE=1; shards missing)")
        return self.report()

    def report(self) -> int:
        n_jobs = len({a['out'] for a in self.acked})
        tr = getattr(self, "trace_summary", None) or {}
        self._log(f"summary: {len(self.acked)} submits over {n_jobs} "
                  f"unique job(s), {self.takeovers_seen} takeover(s), "
                  f"{self.adoptions_seen} adoption(s), "
                  f"{self.quarantines_seen} quarantine(s), "
                  f"{self.brownouts_seen} brownout recovery(ies), "
                  f"final epoch {self.last_epoch}, "
                  f"{tr.get('spans', 0)} trace "
                  f"span(s) in {tr.get('traces', 0)} trace(s), "
                  f"{tr.get('orphans', 0)} orphan(s)")
        if self.netchaos:
            self._log(f"netchaos summary: {self.partitions_seen} worker "
                      f"partition(s), {self.asym_partitions_seen} "
                      f"asymmetric router split(s), {self.flaps_seen} "
                      f"link flap(s), {self.wire_crc_seen} corrupted "
                      "frame(s) caught by the wire crc")
        if self.violations:
            for v in self.violations:
                print(f"chaos: FAIL {v}", file=sys.stderr, flush=True)
            return 1
        self._log("OK — every invariant held through the schedule")
        return 0

    def teardown(self) -> None:
        procs = [(rid, r["proc"]) for rid, r in self.routers.items()
                 if r["proc"] is not None and r["proc"].poll() is None]
        procs += [(n, w["proc"]) for n, w in self.workers.items()
                  if w["proc"] is not None and w["proc"].poll() is None]
        for _, proc in procs:
            try:
                proc.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + 120.0
        for tag, proc in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                print(f"chaos: {tag} ignored SIGTERM; killing",
                      file=sys.stderr, flush=True)
                proc.kill()


# the finish's verdict on the poison key when the reference's fault trips
POISON_LOST = r"acked key {key} unresolvable after 90s: .*unknown job_id"


def _quarantine_holder(c: Conductor) -> str | None:
    """The worker whose journal carries the poison key's ``quarantined``
    marker."""
    for name, w in c.workers.items():
        try:
            raw = open(w["journal"], "rb").read()
        except OSError:
            continue
        for line in raw.split(b"\n"):
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("kind") == "quarantined" \
                    and rec.get("key") == c.poison["key"]:
                return name
    return None


def reference_poison_fault(c: Conductor, rc: int) -> str | None:
    """A finished run judged against the reference's lost poison verdict,
    which the port keeps (ROADMAP, "Faults found in the reference"): once
    the poison key's quarantine lands on a worker that the schedule kills
    for good, whose journal a router adopts and which returns as a zombie
    dropping the adopted jobs, no node answers for the key.  Where the
    quarantine lands follows the key, which hashes the workdir, so a run
    meets these conditions or not by its path.  Returns that worker when
    the run met them and ended rc 1 with that one violation, None when it
    did not and ended rc 0 with none; raises ``AssertionError`` on any
    other outcome."""
    holder = _quarantine_holder(c) if c.poison is not None else None
    tripped = holder is not None and not c.workers[holder]["permanent"] \
        and journal_tombstoned(c.workers[holder]["journal"])
    lost = tripped and len(c.violations) == 1 and re.fullmatch(
        POISON_LOST.format(key=re.escape(c.poison["key"])), c.violations[0])
    if rc != (1 if tripped else 0) or not (lost if tripped else not c.violations):
        raise AssertionError(
            f"chaos: rc {rc}, violations {c.violations}; the reference's poison "
            f"fault {'met' if tripped else 'not met'} (quarantine on {holder})")
    return holder if tripped else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True,
                    help="scratch directory for sockets/journals/outputs")
    ap.add_argument("--events", type=int, default=30,
                    help="random events in the schedule (structural "
                         "failover/adoption/membership events are always "
                         "added on top; default 30)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the whole schedule (reproducible chaos)")
    ap.add_argument("--workers", type=int, default=3,
                    help="initial fleet size (default 3)")
    ap.add_argument("--jobs", type=int, default=6,
                    help="max unique consensus jobs (default 6)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-job completion deadline at the end")
    ap.add_argument("--smoke", action="store_true",
                    help="fixed-seed short leg for CI: 8 random events, "
                         "3 unique jobs, seed 7 unless --seed is given")
    ap.add_argument("--netchaos", action="store_true",
                    help="run the fleet under the deterministic wire-fault "
                         "layer and add the partition/corruption events "
                         "to the schedule")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="forwarded to every worker: where its jobs vote "
                         "(default cuda: the card, failing before any "
                         "spawn without one). cpu runs the kernels' plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    events, jobs, seed = args.events, args.jobs, args.seed
    if args.smoke:
        events, jobs = 8, 3
        if seed == 0:
            seed = 7
    try:
        conductor = Conductor(args.workdir, seed, workers=args.workers,
                              max_unique_jobs=jobs, job_timeout_s=args.timeout,
                              netchaos=args.netchaos, device=args.device)
    except RuntimeError as e:
        print(f"chaos: FAIL {e}", file=sys.stderr, flush=True)
        return 1
    return conductor.run(events)


if __name__ == "__main__":
    sys.exit(main())
