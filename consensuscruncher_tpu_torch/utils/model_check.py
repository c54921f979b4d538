"""Deterministic interleaving model check of the port's serve protocol.

Port of the reference's ``tools/model_check.py`` onto the port's serve
plane.  It *enumerates* thread interleavings of six small scripted
scenarios built from the port's serve primitives (``serve/journal.py``,
``replay``, ``serve/scheduler.Scheduler`` admission/fencing) under
``utils/interleave.py``'s cooperative scheduler, and asserts the journal
grammar (its own copy of the reference's declared protocol tables, below)
and the scenario invariants on every explored schedule.  Every
``Scheduler`` is built with ``start=False``: no dispatcher starts and no
device is touched.

  submit_kill        two same-key submitters race a journal crash:
                     an acknowledged submit is durable and exactly-once
                     in the journal, a refused one left no orphan record
  fence_race         a stale and a fresh router race the worker's epoch
                     fence: the accepted-epoch floor never regresses,
                     rejections always name a strictly higher live epoch
  failover_resubmit  a zombie router (old epoch) races the takeover
                     router resubmitting the same key to a new worker:
                     per-journal exactly-once, fence floors end correct
  adoption_zombie    a returning zombie worker replays its journal while
                     the adopting router resubmits + tombstones it: the
                     job is never lost and never double-owned
  poison_quarantine  an active router and a zombie router (stale lineage
                     rider) race redispatches of one always-crashing key:
                     journaled suspect ordinals never exceed the fleet
                     retry budget, nothing dispatches after the
                     quarantined marker, and replay of a quarantined
                     journal never requeues the key
  partition_takeover a network partition splits the HA pair: the standby
                     takes the worker over (fence epoch 2) while the
                     zombie active router keeps dispatching with epoch 1:
                     no zombie submit is ever acked after the takeover
                     fence committed, and every zombie rejection names
                     the strictly higher live epoch

Three positive-control legs REQUIRE the checker to find seeded bugs —
proof the harness can catch the bug classes it exists for.
``--demo-bug`` runs the fence race against a deliberately seeded
check-then-act fence (the pre-fix shape: read the floor in one lock
region, write it in another) and must find the epoch regression;
``--poison-control`` runs the poison race with fleet budgets DISABLED
(``max_fleet_attempts = 0``) and must find the runaway dispatches;
``--partition-control`` runs the partition race with the per-forward
fence guard REMOVED (the router trusts the ownership check it did at
session start, across the partition) and must find the zombie ack.
``tests/test_torch_model_check.py`` replays the discovered bad schedules.

  python -m consensuscruncher_tpu_torch.utils.model_check          # full run
  python -m consensuscruncher_tpu_torch.utils.model_check --smoke  # bounded, fixed seed
  python -m consensuscruncher_tpu_torch.utils.model_check --scenario fence_race --budget 200
  python -m consensuscruncher_tpu_torch.utils.model_check --demo-bug
  python -m consensuscruncher_tpu_torch.utils.model_check --poison-control
  python -m consensuscruncher_tpu_torch.utils.model_check --partition-control

Exit 0: every explored schedule of every scenario held every invariant
(and, when the demo leg runs, the seeded bug was caught).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile

from consensuscruncher_tpu_torch.serve import journal as journal_mod
from consensuscruncher_tpu_torch.serve.scheduler import (
    AdmissionRefused,
    QuarantineRefused,
    RouterFenced,
    Scheduler,
)
from consensuscruncher_tpu_torch.utils import interleave
from consensuscruncher_tpu_torch.utils.profiling import Counters

# ------------------------------------------------------- journal grammar
#
# The port's copy of the journal part of the reference's declared
# protocol tables (``tools/cctlint/protocols.py``): the same record types,
# states, transitions and marker kinds, and the same validators, so the
# scenarios hold the port's journal to the reference's grammar without
# importing anything outside this package.

JOURNAL_REC_TYPES = ("job", "marker")

# states a journal job record may carry (the in-memory Job has finer ones)
JOURNAL_STATES = ("accepted", "dispatched", "done", "failed")

# legal journal-state successions per job id: self-loops everywhere
# non-terminal (rotation snapshots, replay re-appends), and ``dispatched
# -> accepted`` (a crash before the gang finished demotes the job)
JOURNAL_TRANSITIONS = {
    "accepted": ("accepted", "dispatched", "done", "failed"),
    "dispatched": ("accepted", "dispatched", "done", "failed"),
    "done": ("done",),
    "failed": ("failed",),
}

# marker kinds (``rec: "marker"``): drain boundary, adoption tombstone,
# fence floor, the router's cache answers, crash-attribution suspects
# and the poison verdict
MARKER_KINDS = ("drain", "adopted", "fence", "cache_answer",
                "suspect", "quarantined")


def validate_transition(old, new):
    """Is ``old -> new`` a legal journal-state succession for one id?"""
    if old not in JOURNAL_TRANSITIONS:
        return f"unknown journal state {old!r}"
    if new not in JOURNAL_TRANSITIONS:
        return f"unknown journal state {new!r}"
    if new not in JOURNAL_TRANSITIONS[old]:
        return f"illegal journal transition {old!r} -> {new!r}"
    return None


def check_state_sequence(states):
    """Validate a whole per-id record sequence; first violation or None."""
    prev = None
    for state in states:
        if prev is None:
            if state not in JOURNAL_TRANSITIONS:
                return f"unknown journal state {state!r}"
        else:
            err = validate_transition(prev, state)
            if err:
                return err
        prev = state
    return None


def validate_journal_record(rec):
    """Grammar-check one parsed journal line (job or marker record)."""
    if not isinstance(rec, dict):
        return "journal record is not an object"
    if rec.get("v") not in (1, 2):
        return f"unknown journal record version {rec.get('v')!r}"
    if rec.get("v") == 2 and not isinstance(rec.get("crc"), int):
        # v2 IS the crc generation: a v2 record without the field means
        # the crc (or its key) was corrupted away — never legacy
        return "v2 journal record without an integer crc"
    kind = rec.get("rec")
    if kind not in JOURNAL_REC_TYPES:
        return f"unknown journal record type {kind!r}"
    if kind == "job":
        if not isinstance(rec.get("id"), int):
            return "job record without an integer id"
        if rec.get("state") not in JOURNAL_STATES:
            return f"job record with unknown state {rec.get('state')!r}"
    else:
        if rec.get("kind") not in MARKER_KINDS:
            return f"marker record with unknown kind {rec.get('kind')!r}"
    return None


def _journal_grammar_violations(path: str, label: str) -> list[str]:
    """Every decodable record obeys the registry grammar and every job
    id's state sequence is a legal succession (file order)."""
    msgs: list[str] = []
    if not os.path.exists(path):
        return msgs
    per_id: dict[int, list[str]] = {}
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    for line in lines:
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn tail: replay's tolerance, not a violation
        err = validate_journal_record(rec)
        if err:
            msgs.append(f"{label}: {err}: {rec!r}")
            continue
        if rec.get("rec") == "job":
            per_id.setdefault(int(rec["id"]), []).append(rec["state"])
    for jid, states in sorted(per_id.items()):
        err = check_state_sequence(states)
        if err:
            msgs.append(f"{label}: job {jid}: {err} (sequence {states})")
    return msgs


def _accepted_ids_for_key(path: str, key: str) -> set[int]:
    ids: set[int] = set()
    if not os.path.exists(path):
        return ids
    with open(path, "rb") as fh:
        for line in fh.read().split(b"\n"):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("rec") == "job" and rec.get("key") == key:
                ids.add(int(rec["id"]))
    return ids


def _scratch() -> str:
    return tempfile.mkdtemp(prefix="mc_")


def _close(sched) -> None:
    """Close a scenario scheduler's journal fd (checks run hundreds of
    schedules per process; leaked fds would hit the ulimit)."""
    try:
        if sched._journal is not None:
            sched._journal.close()
    except Exception:
        pass


# ------------------------------------------------------------- scenarios


def build_submit_kill(runner):
    """Two submitters race the same idempotent spec while a third task
    kills the journal at an arbitrary point."""
    tmp = _scratch()
    path = os.path.join(tmp, "journal.ndjson")
    sched = Scheduler(start=False, journal=path, queue_bound=8,
                      result_ttl_s=600.0, result_max=8)
    spec = {"input": "a.bam", "output": "out", "name": "mc-submit"}
    key = journal_mod.idempotency_key(spec)
    acked: list[tuple[str, int]] = []
    refused: list[str] = []

    def submitter(name):
        def fn():
            try:
                job, _created = sched.submit_info(dict(spec))
                acked.append((name, job.id))
            except AdmissionRefused:
                refused.append(name)
        return fn

    runner.spawn("submit-a", submitter("a"))
    runner.spawn("submit-b", submitter("b"))
    runner.spawn("killer", lambda: sched._journal.close())

    def check():
        _close(sched)
        msgs = _journal_grammar_violations(path, "journal")
        ids = _accepted_ids_for_key(path, key)
        if acked and not ids:
            msgs.append(f"exactly-once ack broken: {acked} acknowledged "
                        "but no durable record exists")
        if len(ids) > 1:
            msgs.append(f"exactly-once broken: {len(ids)} journal ids for "
                        f"one idempotency key ({sorted(ids)})")
        if len(acked) + len(refused) != 2:
            msgs.append(f"submitter outcome lost: acked={acked} "
                        f"refused={refused}")
        shutil.rmtree(tmp, ignore_errors=True)
        return msgs

    return check


def _fence_scenario(fence_fn):
    """Shared shape of the correct and seeded-buggy fence races: a stale
    router (epoch 5) and a takeover router (epoch 6) race one worker's
    epoch admission, each submitting after a successful fence."""

    def build(runner):
        tmp = _scratch()
        path = os.path.join(tmp, "journal.ndjson")
        sched = Scheduler(start=False, journal=path, queue_bound=8,
                          result_ttl_s=600.0, result_max=8)
        events: list[tuple] = []

        def router(epoch):
            def fn():
                try:
                    fence_fn(sched, epoch, router=f"r{epoch}")
                    events.append(("accept", epoch))
                    spec = {"input": f"e{epoch}.bam", "output": "out",
                            "name": f"mc-fence-{epoch}"}
                    sched.submit_info(spec)
                    events.append(("submit", epoch))
                except RouterFenced as e:
                    events.append(("reject", epoch, e.epoch))
                except AdmissionRefused:
                    events.append(("refused", epoch))
            return fn

        runner.spawn("router-old", router(5))
        runner.spawn("router-new", router(6))

        def check():
            _close(sched)
            msgs = _journal_grammar_violations(path, "journal")
            floor = sched.fence_epoch
            # NOTE: the events list records task-side append order, which
            # is NOT the lock-side linearization order — only order-free
            # invariants (max accepted, per-event rejection facts) are
            # judged here; the floor itself is the linearized witness
            hi = 0
            for ev in events:
                if ev[0] == "accept":
                    hi = max(hi, ev[1])
                elif ev[0] == "reject" and ev[2] <= ev[1]:
                    msgs.append(
                        f"rejection without a higher live epoch: epoch "
                        f"{ev[1]} rejected citing live {ev[2]}")
            if hi and floor < hi:
                msgs.append(f"epoch floor regressed: final fence floor "
                            f"{floor} < highest accepted epoch {hi}")
            shutil.rmtree(tmp, ignore_errors=True)
            return msgs

        return check

    return build


def _real_fence(sched, epoch, router=None):
    sched.fence(epoch, router=router)


def _buggy_fence(sched, epoch, router=None):
    """The seeded bug: a pre-fix check-then-act fence.  The floor is read
    in one lock region and written in another, so a stale router that
    passed the check before a takeover can write the floor back DOWN —
    the exact TOCTOU ``Scheduler.fence`` avoids by doing both under one
    ``_cond`` region.  Kept here (not in shipping code) as the
    model checker's positive control."""
    floor = sched.fence_epoch  # lock region 1: read + check
    if epoch < floor:
        raise RouterFenced(floor, f"stale forward from {router!r}")
    with sched._cond:  # lock region 2: act — too late, the world moved
        sched._fence_epoch = epoch


build_fence_race = _fence_scenario(_real_fence)
build_fence_race_seeded_bug = _fence_scenario(_buggy_fence)


def build_failover_resubmit(runner):
    """A zombie router (epoch 1) and the takeover router (epoch 2) race
    the same key onto two workers after a failover."""
    tmp = _scratch()
    paths = {n: os.path.join(tmp, f"w{n}.ndjson") for n in (1, 2)}
    workers = {n: Scheduler(start=False, journal=paths[n], queue_bound=8,
                            result_ttl_s=600.0, result_max=8)
               for n in (1, 2)}
    spec = {"input": "f.bam", "output": "out", "name": "mc-failover"}
    key = journal_mod.idempotency_key(spec)
    outcomes: list[tuple] = []

    def old_router():
        try:
            workers[1].fence(1, router="r-old")
            workers[1].submit_info(dict(spec))
            outcomes.append(("old-acked", 1))
        except RouterFenced as e:
            outcomes.append(("old-fenced", e.epoch))
        except AdmissionRefused:
            outcomes.append(("old-refused",))

    def new_router():
        try:
            # takeover: fence the surviving worker up, then resubmit the
            # possibly-lost key to its new ring home
            workers[1].fence(2, router="r-new")
            workers[2].fence(2, router="r-new")
            workers[2].submit_info(dict(spec))
            outcomes.append(("new-acked", 2))
        except RouterFenced as e:
            outcomes.append(("new-fenced", e.epoch))
        except AdmissionRefused:
            outcomes.append(("new-refused",))

    runner.spawn("router-old", old_router)
    runner.spawn("router-new", new_router)

    def check():
        msgs = []
        for n in (1, 2):
            _close(workers[n])
            msgs += _journal_grammar_violations(paths[n], f"w{n}")
            ids = _accepted_ids_for_key(paths[n], key)
            if len(ids) > 1:
                msgs.append(f"w{n}: {len(ids)} journal ids for one key")
        if ("new-acked", 2) in outcomes and workers[2].fence_epoch != 2:
            msgs.append("w2 acked the takeover submit without having "
                        f"accepted epoch 2 (floor {workers[2].fence_epoch})")
        for tag, *rest in outcomes:
            if tag == "old-fenced" and rest[0] <= 1:
                msgs.append(f"old router fenced citing live epoch "
                            f"{rest[0]} <= its own 1")
        shutil.rmtree(tmp, ignore_errors=True)
        return msgs

    return check


def build_adoption_zombie(runner):
    """The adoption contract under every interleaving: a dead
    worker's journal holds an acked non-terminal job; the router adopts
    it (resubmit to the successor, then tombstone) while the dead worker
    returns as a zombie and replays.  The job must never be lost, and a
    zombie that honours the tombstone must be able to rely on the
    successor already having the job durably."""
    tmp = _scratch()
    dead_path = os.path.join(tmp, "dead.ndjson")
    succ_path = os.path.join(tmp, "succ.ndjson")
    spec = {"input": "z.bam", "output": "out", "name": "mc-adopt"}
    key = journal_mod.idempotency_key(spec)
    # prefill (un-scheduled: build runs before the hook installs): the
    # dead worker acked the job, then died
    dead = journal_mod.Journal(dead_path)
    dead.append_job(9001, "accepted", key=key, spec=spec)
    dead.close()
    succ = Scheduler(start=False, journal=succ_path, queue_bound=8,
                     result_ttl_s=600.0, result_max=8)
    state: dict = {"zombie": None, "tombstoned": False}

    def adopter():
        jobs, _info = journal_mod.replay(dead_path)
        for _jid, rec in sorted(jobs.items()):
            if rec.get("state") in ("done", "failed") or rec.get("adopted"):
                continue
            succ.submit_info(dict(rec["spec"]))
        tomb = journal_mod.Journal(dead_path)
        try:
            tomb.append_marker("adopted", router="r-new", epoch=2)
        finally:
            tomb.close()
        state["tombstoned"] = True

    def zombie():
        z = Scheduler(start=False, journal=dead_path, queue_bound=8,
                      result_ttl_s=600.0, result_max=8)
        with z._cond:
            queued = sum(len(q) for q in z._queues.values())
        state["zombie"] = {
            "queued": queued,
            "dropped": z.counters.snapshot()["fencing_rejections"],
        }
        z._journal.close()

    runner.spawn("adopter", adopter)
    runner.spawn("zombie", zombie)

    def check():
        _close(succ)
        msgs = _journal_grammar_violations(dead_path, "dead")
        msgs += _journal_grammar_violations(succ_path, "succ")
        succ_ids = _accepted_ids_for_key(succ_path, key)
        if len(succ_ids) > 1:
            msgs.append(f"succ: {len(succ_ids)} journal ids for one key")
        z = state["zombie"]
        if z is None:
            msgs.append("zombie task never completed its replay")
        else:
            if z["dropped"] and not succ_ids:
                msgs.append(
                    "lost job: the zombie honoured an adoption tombstone "
                    "but the successor journal has no durable record — "
                    "the tombstone was appended before the resubmit ack")
            if not z["dropped"] and z["queued"] == 0 and not succ_ids:
                msgs.append("lost job: neither the zombie nor the "
                            "successor owns the acked job")
        shutil.rmtree(tmp, ignore_errors=True)
        return msgs

    return check


def _poison_scenario(budget: int):
    """Shared shape of the correct and budget-off poison races: an active
    router and a zombie router (stale lineage rider) race redispatches of
    one always-crashing key onto two workers.  The active router fails
    over to w2 carrying the merged lineage; the zombie hammers w1 with a
    stale rider of 0 — the exact shape a partitioned HA pair produces.
    ``budget`` is the per-key fleet attempt cap (0 = the seeded control:
    budgets disabled, the checker must catch the runaway)."""

    def build(runner):
        tmp = _scratch()
        paths = {n: os.path.join(tmp, f"w{n}.ndjson") for n in (1, 2)}
        workers = {}
        for n in (1, 2):
            w = Scheduler(start=False, journal=paths[n], queue_bound=8,
                          result_ttl_s=600.0, result_max=8, node=f"w{n}")
            w.max_fleet_attempts = budget
            workers[n] = w
        spec = {"input": "p.bam", "output": "out", "name": "mc-poison"}
        key = journal_mod.idempotency_key(spec)
        view = {"attempts": 0}  # the ring-view lineage both routers share
        events: list[tuple] = []

        def dispatch_once(w, rider):
            """One router redispatch: forward the submit with the lineage
            rider (the worker max-merges it), then run the worker's
            pre-dispatch budget gate — suspect marker or quarantine."""
            job, _created = w.submit_info(dict(spec), fleet_attempts=rider)
            with w._cond:
                parked = w._predispatch_locked(job)
            return parked

        def active_router():
            # dispatch on the home node, then fail over to w2 forwarding
            # the merged lineage (what _failover_resubmit does)
            for n in (1, 2, 2):
                try:
                    if dispatch_once(workers[n], view["attempts"]):
                        events.append(("quarantined", "active", n))
                        return
                    events.append(("dispatched", "active", n))
                except QuarantineRefused:
                    events.append(("refused", "active", n))
                    return
                except AdmissionRefused:
                    events.append(("admission", "active", n))
                view["attempts"] = max(view["attempts"],
                                       workers[n].fleet_attempts(key))

        def zombie_router():
            # a zombie never refreshed its view: rider 0, home node only
            for _ in range(4):
                try:
                    if dispatch_once(workers[1], 0):
                        events.append(("quarantined", "zombie", 1))
                        return
                    events.append(("dispatched", "zombie", 1))
                except QuarantineRefused:
                    events.append(("refused", "zombie", 1))
                    return
                except AdmissionRefused:
                    events.append(("admission", "zombie", 1))

        runner.spawn("router-active", active_router)
        runner.spawn("router-zombie", zombie_router)

        def check():
            msgs = []
            cap = budget or 2  # the control judges against the real cap
            for n in (1, 2):
                _close(workers[n])
                msgs += _journal_grammar_violations(paths[n], f"w{n}")
                # order-sensitive marker walk: suspect ordinals never
                # exceed the fleet budget, and nothing dispatches after
                # the quarantined marker (quarantine is near-terminal)
                suspects = 0
                quarantined_at = None
                with open(paths[n], "rb") as fh:
                    lines = fh.read().split(b"\n")
                for line in lines:
                    if not line.strip():
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("rec") != "marker" or rec.get("key") != key:
                        continue
                    if rec.get("kind") == "suspect":
                        suspects += 1
                        if int(rec.get("attempt") or 0) > cap:
                            msgs.append(
                                f"w{n}: suspect ordinal "
                                f"{rec.get('attempt')} exceeds the fleet "
                                f"budget {cap}")
                        if quarantined_at is not None:
                            msgs.append(
                                f"w{n}: dispatch (suspect marker) AFTER "
                                "the quarantined marker — quarantine did "
                                "not stop the poison")
                    elif rec.get("kind") == "quarantined" \
                            and not rec.get("released"):
                        quarantined_at = suspects
                if suspects > cap:
                    msgs.append(f"w{n}: {suspects} dispatches for one key "
                                f"exceed the fleet budget {cap}")
                # replay honours the verdict: a quarantined journal must
                # not hand the key another dispatch on recovery
                _jobs, info = journal_mod.replay(paths[n])
                if key in info["quarantined"]:
                    z = Scheduler(start=False, journal=paths[n],
                                  queue_bound=8, result_ttl_s=600.0,
                                  result_max=8)
                    with z._cond:
                        queued = sum(len(q) for q in z._queues.values())
                    _close(z)
                    if queued:
                        msgs.append(
                            f"w{n}: replay requeued a quarantined key "
                            f"({queued} queued)")
            shutil.rmtree(tmp, ignore_errors=True)
            return msgs

        return check

    return build


build_poison_quarantine = _poison_scenario(budget=2)
build_poison_quarantine_budget_off = _poison_scenario(budget=0)


def _partition_scenario(guarded: bool):
    """Shared shape of the correct and seeded-buggy partition takeovers:
    a partition splits the HA pair, the standby (r1) fences the worker
    to epoch 2 and resubmits while the zombie active router (r0, epoch
    1) keeps dispatching across the partition.

    ``guarded=True`` models the shipping router: every forward
    re-asserts its epoch against the worker's fence immediately before
    the submit (the per-request epoch stamp ``Router._forward`` sends,
    checked atomically under the scheduler lock).  The seeded control
    (``guarded=False``) models a router that fenced once at session
    start and never again — dispatches ride a cached ownership check
    across the partition, so a zombie ack after the takeover committed
    is reachable and MUST be caught.

    The split-brain witness is linearized at the fence: ``took_over`` is
    read BEFORE the guard fence, and the standby sets it only AFTER its
    takeover fence returned.  So ``took_over`` observed True at dispatch
    time proves the floor was already 2, and a guarded forward would
    have been rejected — any ack carrying that witness is a zombie ack."""

    def build(runner):
        tmp = _scratch()
        path = os.path.join(tmp, "journal.ndjson")
        sched = Scheduler(start=False, journal=path, queue_bound=8,
                          result_ttl_s=600.0, result_max=8)
        state = {"took_over": False}
        events: list[tuple] = []

        def zombie_active():
            # session handshake: r0 owned the worker before the partition
            try:
                sched.fence(1, router="r0")
            except RouterFenced as e:
                events.append(("r0-fenced", e.epoch))
                return
            for n in (1, 2):  # two dispatch rounds across the partition
                took = state["took_over"]  # the dispatch-time witness
                try:
                    if guarded:
                        sched.fence(1, router="r0")  # per-forward stamp
                    sched.submit_info({"input": f"r0-{n}.bam",
                                       "output": "out",
                                       "name": f"mc-part-r0-{n}"})
                    events.append(("r0-acked", took))
                except RouterFenced as e:
                    events.append(("r0-fenced", e.epoch))
                    return
                except AdmissionRefused:
                    events.append(("r0-refused",))

        def standby_takeover():
            try:
                sched.fence(2, router="r1")
            except RouterFenced as e:
                events.append(("r1-fenced", e.epoch))
                return
            state["took_over"] = True
            try:
                sched.submit_info({"input": "r1.bam", "output": "out",
                                   "name": "mc-part-r1"})
                events.append(("r1-acked",))
            except AdmissionRefused:
                events.append(("r1-refused",))

        runner.spawn("router-active", zombie_active)
        runner.spawn("router-standby", standby_takeover)

        def check():
            _close(sched)
            msgs = _journal_grammar_violations(path, "journal")
            for ev in events:
                if ev[0] == "r0-acked" and ev[1]:
                    msgs.append(
                        "split-brain: the zombie active router's submit "
                        "was acked AFTER the standby's takeover fence "
                        "committed (dispatch-time takeover witness set) — "
                        "a fence-guarded forward would have been rejected")
                elif ev[0] == "r0-fenced" and ev[1] <= 1:
                    msgs.append(f"r0 fenced citing live epoch {ev[1]} <= "
                                "its own 1")
            if ("r1-acked",) in events and sched.fence_epoch < 2:
                msgs.append("standby acked its takeover submit but the "
                            f"fence floor is {sched.fence_epoch} < 2")
            shutil.rmtree(tmp, ignore_errors=True)
            return msgs

        return check

    return build


build_partition_takeover = _partition_scenario(guarded=True)
build_partition_takeover_unguarded = _partition_scenario(guarded=False)


SCENARIOS = {
    "submit_kill": build_submit_kill,
    "fence_race": build_fence_race,
    "failover_resubmit": build_failover_resubmit,
    "adoption_zombie": build_adoption_zombie,
    "poison_quarantine": build_poison_quarantine,
    "partition_takeover": build_partition_takeover,
}


# ------------------------------------------------------------------ main


def _explore_quiet(ex, verbose: bool):
    """Scenario schedulers narrate replay/adoption to stderr on every
    schedule; hundreds of runs would drown the verdict, so mute it."""
    if verbose:
        return ex.explore()
    with contextlib.redirect_stderr(io.StringIO()):
        return ex.explore()


def run_scenarios(names, *, seed: int, budget: int, dpor: bool = True,
                  verbose: bool = False):
    """Explore each named scenario; returns the summary doc."""
    counters = Counters()
    doc = {"scenarios": {}, "schedules": 0, "violations": 0, "deadlocks": 0}
    for name in names:
        ex = interleave.Explorer(SCENARIOS[name], seed=seed,
                                 max_schedules=budget, dpor=dpor)
        res = _explore_quiet(ex, verbose)
        doc["scenarios"][name] = {
            "schedules": res["schedules"],
            "max_depth": res["max_depth"],
            "deadlocks": res["deadlocks"],
            "violations": [
                {"schedule": sched, "messages": msgs}
                for sched, msgs in res["violations"]
            ],
        }
        doc["schedules"] += res["schedules"]
        doc["violations"] += len(res["violations"])
        doc["deadlocks"] += res["deadlocks"]
        counters.add("mc_interleavings", res["schedules"])
        counters.add("mc_violations", len(res["violations"]))
        counters.add("mc_deadlocks", res["deadlocks"])
        status = "OK" if not res["violations"] else "VIOLATIONS"
        print(f"model_check: {name}: {res['schedules']} schedules, "
              f"max depth {res['max_depth']}, {res['deadlocks']} deadlocks, "
              f"{len(res['violations'])} violations [{status}]", flush=True)
        for sched, msgs in res["violations"][:5]:
            print(f"  schedule {sched}:", flush=True)
            for m in msgs:
                print(f"    - {m}", flush=True)
    doc["counters"] = {k: v for k, v in counters.snapshot().items()
                       if k.startswith("mc_")}
    return doc


def run_demo_bug(*, seed: int, budget: int,
                 verbose: bool = False) -> tuple[bool, list[int] | None]:
    """Positive control: the checker must find the seeded fence TOCTOU.
    Returns (caught, first violating schedule)."""
    ex = interleave.Explorer(build_fence_race_seeded_bug, seed=seed,
                             max_schedules=budget)
    res = _explore_quiet(ex, verbose)
    if res["violations"]:
        sched, msgs = res["violations"][0]
        print(f"model_check: demo-bug: CAUGHT in {res['schedules']} "
              f"schedules; first bad schedule {sched}:", flush=True)
        for m in msgs:
            print(f"    - {m}", flush=True)
        return True, sched
    print(f"model_check: demo-bug: NOT caught in {res['schedules']} "
          "schedules — the checker lost its positive control", flush=True)
    return False, None


def run_poison_control(*, seed: int, budget: int,
                       verbose: bool = False) -> tuple[bool, list[int] | None]:
    """Positive control: with fleet budgets disabled the poison race MUST
    produce runaway dispatches the invariants flag.  Returns (caught,
    first violating schedule)."""
    ex = interleave.Explorer(build_poison_quarantine_budget_off, seed=seed,
                             max_schedules=budget)
    res = _explore_quiet(ex, verbose)
    if res["violations"]:
        sched, msgs = res["violations"][0]
        print(f"model_check: poison-control: CAUGHT in {res['schedules']} "
              f"schedules; first bad schedule {sched}:", flush=True)
        for m in msgs[:5]:
            print(f"    - {m}", flush=True)
        return True, sched
    print(f"model_check: poison-control: NOT caught in {res['schedules']} "
          "schedules — budgets-off ran clean; the checker lost its "
          "positive control", flush=True)
    return False, None


def run_partition_control(*, seed: int, budget: int,
                          verbose: bool = False
                          ) -> tuple[bool, list[int] | None]:
    """Positive control: with the per-forward fence guard removed the
    partitioned zombie router MUST produce an ack after the standby's
    takeover fence committed.  Returns (caught, first violating
    schedule)."""
    ex = interleave.Explorer(build_partition_takeover_unguarded, seed=seed,
                             max_schedules=budget)
    res = _explore_quiet(ex, verbose)
    if res["violations"]:
        sched, msgs = res["violations"][0]
        print(f"model_check: partition-control: CAUGHT in "
              f"{res['schedules']} schedules; first bad schedule {sched}:",
              flush=True)
        for m in msgs[:5]:
            print(f"    - {m}", flush=True)
        return True, sched
    print(f"model_check: partition-control: NOT caught in "
          f"{res['schedules']} schedules — the unguarded zombie ran "
          "clean; the checker lost its positive control", flush=True)
    return False, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=sorted(SCENARIOS),
                    help="run one scenario instead of all six")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget", type=int, default=250,
                    help="max schedules per scenario (default 250)")
    ap.add_argument("--smoke", action="store_true",
                    help="bounded CI leg: fixed seed, small budget")
    ap.add_argument("--no-dpor", action="store_true",
                    help="disable pruning (full enumeration up to budget)")
    ap.add_argument("--demo-bug", action="store_true",
                    help="only run the seeded fence-bug positive control")
    ap.add_argument("--poison-control", action="store_true",
                    help="only run the budgets-off poison positive control")
    ap.add_argument("--partition-control", action="store_true",
                    help="only run the unguarded-zombie partition "
                         "positive control")
    ap.add_argument("--replay", type=str, default=None,
                    help="JSON schedule to replay (with --scenario or "
                         "--demo-bug); prints the verdict for that one "
                         "interleaving")
    ap.add_argument("--json", action="store_true",
                    help="print the summary doc as JSON on stdout")
    ap.add_argument("--verbose", action="store_true",
                    help="let scenario schedulers narrate to stderr")
    args = ap.parse_args(argv)

    if args.smoke:
        args.seed, args.budget = 0, 60

    if args.replay is not None:
        schedule = [int(x) for x in json.loads(args.replay)]
        build = (build_fence_race_seeded_bug if args.demo_bug
                 else build_poison_quarantine_budget_off if args.poison_control
                 else build_partition_takeover_unguarded
                 if args.partition_control
                 else SCENARIOS[args.scenario or "fence_race"])
        _runner, msgs = interleave.run_schedule(build, schedule)
        for m in msgs:
            print(f"  - {m}", flush=True)
        print(f"model_check: replay {schedule}: "
              f"{'VIOLATION' if msgs else 'clean'}", flush=True)
        return 1 if msgs else 0

    if args.demo_bug:
        caught, _sched = run_demo_bug(seed=args.seed, budget=args.budget,
                                      verbose=args.verbose)
        return 0 if caught else 1

    if args.poison_control:
        caught, _sched = run_poison_control(seed=args.seed,
                                            budget=args.budget,
                                            verbose=args.verbose)
        return 0 if caught else 1

    if args.partition_control:
        caught, _sched = run_partition_control(seed=args.seed,
                                               budget=args.budget,
                                               verbose=args.verbose)
        return 0 if caught else 1

    names = [args.scenario] if args.scenario else sorted(SCENARIOS)
    doc = run_scenarios(names, seed=args.seed, budget=args.budget,
                        dpor=not args.no_dpor, verbose=args.verbose)
    caught, _sched = run_demo_bug(seed=args.seed, budget=args.budget,
                                  verbose=args.verbose)
    doc["demo_bug_caught"] = caught
    # the poison control only needs a handful of schedules: with budgets
    # off EVERY schedule dispatches past the cap, so cap the leg's cost
    pcaught = True
    if args.scenario in (None, "poison_quarantine"):
        pcaught, _psched = run_poison_control(
            seed=args.seed, budget=min(args.budget, 40),
            verbose=args.verbose)
        doc["poison_control_caught"] = pcaught
    partcaught = True
    if args.scenario in (None, "partition_takeover"):
        partcaught, _zsched = run_partition_control(
            seed=args.seed, budget=args.budget, verbose=args.verbose)
        doc["partition_control_caught"] = partcaught
    if args.json:
        print(json.dumps(doc, sort_keys=True), flush=True)
    ok = doc["violations"] == 0 and caught and pcaught and partcaught
    print(f"model_check: total {doc['schedules']} schedules, "
          f"{doc['violations']} violations, demo bug "
          f"{'caught' if caught else 'MISSED'}, poison control "
          f"{'caught' if pcaught else 'MISSED'}, partition control "
          f"{'caught' if partcaught else 'MISSED'} -> "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
