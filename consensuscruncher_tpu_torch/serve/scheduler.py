"""Admission-controlled job queue with cross-request continuous batching.

Port of ``consensuscruncher_tpu/serve/scheduler.py``.  The scheduler owns
a bounded queue of consensus jobs and a single dispatcher thread.  Each
dispatch round pops a *gang* of compatible queued jobs (same
cutoff/qualscore/vote policy) and runs their SSCS stage as ONE merged
device stream: every job's family events are interleaved round-robin
(``parallel.batching.interleave_sources``) into a single
``ops.consensus_dense.consensus_families`` call, so one launch of B1's
dense form (``csrc/consensus_vote.cu``) carries families from several
requests — the continuous-batching discipline that keeps the card busy
under many small inputs.  The gang's vote policy is passed to that call
explicitly; the port has no process-global policy hook.

Byte-identity with the one-shot CLI path holds by construction:

- packed family *content* is source-local (``rectangularize`` sees one
  family at a time), so interleaving changes batch composition but never
  the per-family vote inputs — and dense-vs-stream wire parity is pinned
  by the port's tests;
- each job's records, stats and sidecars are written by a
  ``stages.sscs_maker.SscsSink``, the one-shot stage's own;
- every sorting writer orders output by content-keyed sort, never batch
  order, so cross-request batch composition cannot leak into file bytes.

After the gang SSCS, each job's "sscs" manifest entry is recorded by
``sscs_maker.manifest_entry``, the function the port's ``consensus
--resume`` checks the stage with, and the job
finishes through ``cli.main(["consensus", ..., "--resume", "True"])`` —
the resume path skips the recorded stage and runs the rest warm.  A
failed job retries through the same resume path (bounded,
``CCT_SERVE_RETRIES``), which the stages' atomic commits make safe: a
death mid-stage never leaves a partial output to resume over.

Durability (``serve.journal``): when constructed with a journal, every
admission is acknowledged only after its ``accepted`` record is fsync'd,
every transition is journaled, and ``__init__`` replays the journal before
the dispatcher starts — any job not provably terminal is re-enqueued and
finishes via ``--resume`` (exactly-once at the output level, byte-identical
to an uninterrupted run).  Duplicate submits dedupe on the spec's
idempotency key, so a client resubmitting across a daemon restart gets the
existing job instead of double-running it.

Overload robustness: a submit may carry ``deadline_s``.  Admission sheds
jobs that cannot meet their deadline at the observed per-job service rate
(EWMA), and dispatch sheds queued jobs whose deadline already expired
while waiting — both counted in ``jobs_shed``.  Completed-job records are
evicted after ``CCT_SERVE_RESULT_TTL_S`` (or beyond ``CCT_SERVE_RESULT_MAX``)
so a long-lived daemon's memory stays bounded; an evicted job's result
points at its on-disk outputs.

Multi-tenancy (``tenant``/``qos`` spec fields): every job belongs to a
tenant (default ``"default"``) and a qos class (``interactive`` /
``batch`` / ``scavenger``).  Each class has its own FIFO queue and the
dispatcher picks the next class by **stride scheduling** — the class
with the least accumulated virtual "pass", advanced by ``1/weight`` per
dispatched job — which is deterministic weighted-fair sharing: with
weights 8/3/1 a saturated daemon gives the classes 8:3:1 of its dispatch
slots, an idle class costs nothing, and a class waking from idle cannot
bank credit (its pass is clamped to the current leader).  Gangs never
span classes, so fairness accounting stays exact.  Per-tenant admission
quotas (``tenant_queue_cap`` queued slots, ``tenant_inflight_cap``
queued+running) raise :class:`QuotaRefused` so one tenant cannot starve
the rest of the queue.  Deadline shedding generalizes to per-class SLO
targets: a job without an explicit ``deadline_s`` inherits its class
target (when configured), and every terminal/shed event feeds the
:class:`~consensuscruncher_tpu_torch.obs.slo.SloMonitor` (p50/p99, shed rate,
multi-window burn rates on ``metrics``/``healthz``).  The default path —
no tenant/qos in the spec, no targets configured — is byte-identical to
the single-tenant scheduler: one nonempty interactive queue is plain
FIFO and the monitor only aggregates.

Failure containment (defense in depth against poison jobs and resource
exhaustion):

- **fleet retry budget** — a ``suspect`` journal marker (key, attempt
  ordinal, node) is fsync'd BEFORE each dispatch, so replay after a
  kill -9 can blame the job that was in flight; the per-key attempt
  lineage is capped by ``CCT_SERVE_MAX_FLEET_ATTEMPTS`` and a job whose
  budget is spent is **quarantined** (near-terminal, durable via a
  ``quarantined`` marker, releasable with ``cct route --release KEY``)
  instead of crash-looping the fleet;
- **circuit breaker** — ``CCT_SERVE_BREAKER_QUARANTINES`` quarantines
  within ``CCT_SERVE_BREAKER_WINDOW_S`` from one input fingerprint open
  the breaker for that fault domain: admission refuses the fingerprint
  early (``breaker_open`` counter + flight dump);
- **brownout** — an OSError (ENOSPC) on the admission journal append
  first triggers the result cache's emergency ``evict_to_budget`` sweep
  and one retry; if the disk is still full the daemon flips into
  read-only brownout: polls and committed cache hits are still served,
  new admissions are refused with ``{"brownout": true}`` until an
  append succeeds again;
- **watermark shedding** — when queued spec bytes or process RSS
  approach ``CCT_SERVE_QUEUE_BYTES_WATERMARK`` /
  ``CCT_SERVE_RSS_WATERMARK_MB``, admissions shed lowest class first
  (scavenger at 80%, batch at 90%, interactive at 100%).

Fault sites: ``serve.dispatch`` (gang dispatch — jobs fall back to solo
runs), ``serve.worker`` (per-job execution — retried via resume),
``serve.shed`` (admission shedding — forced refusal), ``serve.poison``
(fires only for poison-labeled jobs — a deterministically crashing
input without touching honest jobs), ``serve.enospc`` (disk-full on the
journal append — brownout path), ``serve.oom`` (forces the resource
watermark to 100% — class-ordered shedding), plus
``serve.journal_write`` / ``serve.journal_replay`` in :mod:`.journal`.

With ``result_cache=`` (a :class:`~.result_cache.ResultCache` or a plane
root) a gang first looks each job's content digest up: a hit is copied
into the job's tree with no device batch, a finished miss is inserted.
The cache catches only its own IO and its ``serve.cache`` fault (and
then recomputes); a device or kernel error in the gang still raises.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import Counter, deque

from consensuscruncher_tpu_torch.obs import flight as obs_flight
from consensuscruncher_tpu_torch.obs import history as obs_history
from consensuscruncher_tpu_torch.obs import metrics as obs_metrics
from consensuscruncher_tpu_torch.obs import prof as obs_prof
from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.obs.registry import (
    DEFAULT_QOS,
    DEFAULT_TENANT,
    POLICY_NAMES,
    QOS_CLASSES,
)
from consensuscruncher_tpu_torch.obs.slo import SloMonitor
from consensuscruncher_tpu_torch.serve import journal as journal_mod
from consensuscruncher_tpu_torch.utils import faults, sanitize
from consensuscruncher_tpu_torch.utils.profiling import Counters, metrics_doc


class AdmissionRefused(RuntimeError):
    """Queue full or server draining — the caller should retry later."""


class DeadlineShed(AdmissionRefused):
    """Admission refused because the job cannot meet its deadline."""


class QuotaRefused(AdmissionRefused):
    """Per-tenant queue-slot or in-flight quota exceeded."""


class BrownoutRefused(AdmissionRefused):
    """Journal appends are failing (disk full) — the daemon is in
    read-only brownout: polls and cache hits still served, admissions
    refused with ``{"brownout": true}`` until an append succeeds."""


class QuarantineRefused(AdmissionRefused):
    """The key (or its whole fault domain, via the circuit breaker) is
    quarantined as a poison job — the wire layer answers
    ``{"quarantined": true, "reason": ...}`` instead of retrying."""

    def __init__(self, message: str, reason: str | None = None,
                 key: str | None = None):
        super().__init__(message)
        self.reason = reason or message
        self.key = key


class RouterFenced(RuntimeError):
    """A forward carried a router epoch below the highest this worker has
    accepted: the sender is a zombie router from before a takeover.  The
    wire layer turns this into ``{"fenced": true, "epoch": <live>}`` so
    the stale router demotes itself instead of double-dispatching."""

    def __init__(self, live_epoch: int, message: str):
        super().__init__(message)
        self.epoch = int(live_epoch)


_STATES = ("queued", "running", "done", "failed", "quarantined")

#: reserved tenant for the serve-side golden canary prober: excluded from
#: per-tenant admission quotas and the tenant QC series so synthetic
#: heartbeat probes can never distort real-tenant accounting
CANARY_TENANT = "_canary"


class Job:
    """One submitted consensus request and its lifecycle."""

    _next_id = 0
    # lock-order asserted under CCT_SANITIZE=1 (utils.sanitize); plain
    # threading.Lock semantics otherwise
    _id_lock = sanitize.tracked_lock("job.id_lock")

    def __init__(self, spec: dict, job_id: int | None = None,
                 key: str | None = None, deadline_s: float | None = None,
                 trace_id: str | None = None):
        with Job._id_lock:
            if job_id is None:
                Job._next_id += 1
                job_id = Job._next_id
            else:
                # journal replay preserves ids; fresh jobs continue after
                # the highest replayed one so ids never collide
                job_id = int(job_id)
                Job._next_id = max(Job._next_id, job_id)
            self.id = job_id
        self.spec = dict(spec)
        self.tenant = str(spec.get("tenant") or DEFAULT_TENANT)
        # submit_info validates qos before Job construction; folding an
        # unknown class here (journal replay of a foreign record) keeps
        # recovery from crashing on a single bad row
        qos = str(spec.get("qos") or DEFAULT_QOS)
        self.qos = qos if qos in QOS_CLASSES else DEFAULT_QOS
        self.key = key
        self.deadline_s = deadline_s
        # correlation id minted at submit; every span this job produces —
        # admission, journal append, gang dispatch, device batches, writer
        # commit — carries it, so one grep of the exported trace follows
        # the job end to end
        self.trace_id = trace_id or obs_trace.mint_trace_id()
        # wire trace context of the submit-ack span ({"trace_id", "span",
        # "pid", "hop"}): echoed on the submit reply so the router can
        # link failover resubmits back to this ack, and journaled on the
        # accepted record so adoption can do the same after a kill -9
        self.trace_ctx: dict | None = None
        self.state = "queued"
        self.error: str | None = None
        self.outputs: dict | None = None
        self.wall_s: float | None = None
        # admission -> dispatch wait, fixed at dispatch time; the job
        # span reports it (queue_wait_ms) so the profiler's attribution
        # can split wall into queue vs run without re-deriving it
        self.queue_wait_s: float | None = None
        self.attempts = 0
        self.gang_size = 1  # how many jobs shared this job's SSCS dispatch
        # True when the content-addressed result cache answered this job
        # (materialized bytes, no pipeline run) — surfaced in describe()
        # so clients can split hit/miss latency
        self.cached = False
        # compact consensus-quality summary from the run's qc.json (yields
        # + rates + disagree_rate, never the full plane vectors) — rides
        # describe() and the journal's done record (replay tolerates
        # absence: pre-QC journals simply leave it None)
        self.qc: dict | None = None
        # compact-JSON size of the spec: the unit the queue-byte
        # watermark meters (cheap, computed once at admission)
        try:
            self.spec_bytes = len(json.dumps(
                self.spec, sort_keys=True, separators=(",", ":")))
        except (TypeError, ValueError):
            self.spec_bytes = 0
        self.submitted_t = time.monotonic()
        self.finished_t: float | None = None
        # critpath boundary stamps (absolute monotonic): admit / journal /
        # ack / gang / dispatch / run.  Emitted as ms-from-submit offsets
        # on the terminal ``serve.critpath`` event; obs/critpath.py owns
        # the segment math, the scheduler only records evidence.
        self.stamps: dict[str, float] = {}
        # per-lock wait_us totals at admission (CCT_LOCK_LEDGER=1 only):
        # the baseline the antagonist view deltas against at terminal
        self._lock_wait0: dict[str, int] | None = None

    def stamp(self, name: str) -> None:
        self.stamps[name] = time.monotonic()

    def describe(self) -> dict:
        return {
            "job_id": self.id, "state": self.state, "error": self.error,
            "outputs": self.outputs, "wall_s": self.wall_s,
            "attempts": self.attempts, "gang_size": self.gang_size,
            "input": self.spec.get("input"), "key": self.key,
            "deadline_s": self.deadline_s, "trace_id": self.trace_id,
            "tenant": self.tenant, "qos": self.qos, "cached": self.cached,
            "qc": self.qc, "queue_wait_s": self.queue_wait_s,
        }


def _rss_mb() -> float | None:
    """Process resident-set size in MB via /proc/self/statm (None where
    procfs is unavailable — the RSS watermark simply never engages)."""
    try:
        with open("/proc/self/statm") as fh:
            rss_pages = int(fh.read().split()[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError, IndexError):
        return None


def job_paths(spec: dict) -> dict:
    """Output-tree paths for a job spec — the same naming authority as
    ``cli._consensus_impl`` (``<output>/<name>/{sscs,singleton,...}``)."""
    from consensuscruncher_tpu_torch.stages import sscs_maker

    name = spec.get("name") or os.path.basename(spec["input"]).split(".")[0]
    base = os.path.join(spec["output"], name)
    dirs = {k: os.path.join(base, k)
            for k in ("sscs", "singleton", "dcs", "all_unique", "plots")}
    prefix = os.path.join(dirs["sscs"], name)
    return {"name": name, "base": base, "dirs": dirs, "sscs_prefix": prefix,
            "sscs": sscs_maker.output_paths(prefix)}


def gang_sscs(specs: list[dict], counters: Counters | None = None,
              max_batch: int = 1024,
              trace_ids: list[str] | None = None,
              device="cuda") -> list:
    """Run the SSCS stage for several jobs as ONE merged device stream.

    Families from every job are interleaved round-robin into a single
    ``ops.consensus_dense.consensus_families`` call (B1's dense form on
    ``device``: the card, or the CPU's plain version for ``"cpu"``) keyed
    ``(job_idx, fid)``; the results demux back to one
    ``stages.sscs_maker.SscsSink`` per job, the one-shot stage's own
    writers, stats and sidecars.  The gang's vote policy (shared by every
    spec, validated here) is passed to that call; nothing is installed
    process-wide.  Records each job's manifest entry
    (``sscs_maker.manifest_entry``, what the job's ``consensus --resume``
    checks) on success; aborts every job's writers on failure (no partial
    outputs — the caller runs the jobs solo via resume).

    ``trace_ids`` (one per spec, positional) lets each shared device batch
    be attributed: the per-batch ``device.batch`` trace event lists the
    trace_id of every job whose families rode that dispatch, and a closing
    ``serve.gang_batches`` event gives the gang's batches, the B1 launches
    the vote wrapper counted during the gang (the dispatcher is the only
    thread that launches while a gang runs; the CPU's plain version
    launches nothing) and each job's families.

    Returns one entry per spec: the in-memory SSCS/singleton hand-off for
    jobs whose spec asks for ``pipeline: streaming`` (None for staged jobs
    or when the sort spilled), so the caller can continue those jobs'
    chains without re-reading the stage files.
    """
    from consensuscruncher_tpu_torch.device import resolve_device
    from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
    from consensuscruncher_tpu_torch.ops import consensus_vote
    from consensuscruncher_tpu_torch.ops.consensus_dense import consensus_families
    from consensuscruncher_tpu_torch.parallel.batching import interleave_sources
    from consensuscruncher_tpu_torch.policies import get_policy
    from consensuscruncher_tpu_torch.stages.grouping import stream_families_columnar
    from consensuscruncher_tpu_torch.stages.sscs_maker import SscsSink, manifest_entry
    from consensuscruncher_tpu_torch.utils.manifest import RunManifest

    from consensuscruncher_tpu_torch.ops.consensus_vote import ConsensusConfig

    device = resolve_device(device)
    cutoff = float(specs[0].get("cutoff", 0.7))
    qualscore = int(specs[0].get("qualscore", 0))
    policy = str(specs[0].get("policy") or "majority")
    for s in specs[1:]:
        if (float(s.get("cutoff", 0.7)), int(s.get("qualscore", 0))) != (cutoff, qualscore):
            raise ValueError("gang jobs must share cutoff/qualscore")
        if str(s.get("policy") or "majority") != policy:
            raise ValueError("gang jobs must share a vote policy")
    cfg = ConsensusConfig(cutoff=cutoff, qual_threshold=qualscore)
    vote_policy = get_policy(policy)
    vote_policy.prepare()

    paths = [job_paths(s) for s in specs]
    readers, sinks = [], []
    try:
        for spec, p in zip(specs, paths):
            for d in p["dirs"].values():
                os.makedirs(d, exist_ok=True)
            readers.append(ColumnarReader(spec["input"]))
            sinks.append(SscsSink(p["sscs_prefix"], readers[-1].header,
                                  int(spec.get("compress_level", 6))))
    except BaseException:
        for r in readers:
            r.close()
        for sink in sinks:
            sink.abort()
        raise

    def job_events(i):
        events = stream_families_columnar(readers[i], readers[i].header,
                                          specs[i].get("bdelim", "|"))
        for fid, seqs, quals in sinks[i].family_events(events):
            yield (i, fid), seqs, quals

    tracing = obs_trace.enabled() and trace_ids is not None
    n_batches = 0

    def on_batch(batch):
        nonlocal n_batches
        n_batches += 1
        if counters is not None:
            counters.add("batches_dispatched")
        per_job = Counter(k[0] for k in batch.keys)
        for ji, n in per_job.items():
            sinks[ji].cum.add("families_in", n)
        if tracing:
            # which jobs' families share this device dispatch — distinct
            # trace_ids on one batch span is the whole point of tracing a
            # continuous-batching scheduler
            obs_trace.event(
                "device.batch", n_real=batch.n_real,
                trace_ids=[trace_ids[i] for i in sorted(per_job)])

    ok = False
    launches0 = consensus_vote.launches
    try:
        stream = consensus_families(
            interleave_sources([job_events(i) for i in range(len(specs))]),
            cfg, device, max_batch=max_batch, on_batch=on_batch, policy=vote_policy,
        )
        try:
            for (ji, fid), codes, quals in stream:
                sinks[ji].emit(fid, codes, quals)
        finally:
            # join the prefetch producer (it writes to the per-job writers)
            # BEFORE the writers are closed/aborted below
            stream.close()
        for sink in sinks:
            sink.rec_writer.flush()
        ok = True
    finally:
        for r in readers:
            r.close()
        if not ok:
            for sink in sinks:
                sink.abort()
    if tracing:
        obs_trace.event(
            "serve.gang_batches", batches=n_batches,
            launches=consensus_vote.launches - launches0, trace_ids=list(trace_ids),
            families=[sink.cum.snapshot().get("families_in", 0) for sink in sinks])
    handoffs = []
    for i, (spec, sink) in enumerate(zip(specs, sinks)):
        with obs_trace.span(
                "writer.commit",
                trace_id=trace_ids[i] if trace_ids else None):
            handoffs.append(sink.close(
                handoff=str(spec.get("pipeline", "")) == "streaming"))
            sink.write_sidecars(device, cutoff, vote_policy.name)
            RunManifest(os.path.join(paths[i]["base"], "manifest.json")).record(
                "sscs", *manifest_entry(spec["input"], sink.prefix, cutoff, qualscore,
                                        spec.get("bdelim", "|"), None, vote_policy.name))
    return handoffs


class Scheduler:
    """Bounded job queue + single dispatcher thread (see module docstring).

    ``queue_bound`` caps ADMITTED-but-unfinished work: submit refuses when
    the queue is full (backpressure to the client, never OOM).
    ``gang_size`` caps how many compatible jobs one dispatch round merges.
    ``paused`` holds dispatch so tests can pile up a gang deterministically.
    ``journal`` (a :class:`.journal.Journal` or a path) makes admissions
    durable: the journal is replayed before the dispatcher starts.
    ``result_ttl_s`` / ``result_max`` bound completed-job retention.
    ``class_weights`` sets the stride-scheduling share per qos class;
    ``slo_targets`` sets per-class latency targets (seconds, None = no
    target) that double as implicit deadlines for shedding;
    ``tenant_queue_cap`` / ``tenant_inflight_cap`` bound one tenant's
    queued / queued+running jobs (None = unlimited).
    ``device`` is where every job votes (``"cuda"``, the default, or
    ``"cpu"``); it rides each job's CLI argv as ``--device``.
    """

    DEFAULT_CLASS_WEIGHTS = {"interactive": 8.0, "batch": 3.0,
                             "scavenger": 1.0}

    def __init__(self, queue_bound: int = 16, gang_size: int = 4,
                 device: str = "cuda", max_batch: int = 1024,
                 start: bool = True, paused: bool = False,
                 journal: journal_mod.Journal | str | None = None,
                 result_ttl_s: float | None = None,
                 result_max: int | None = None,
                 class_weights: dict | None = None,
                 slo_targets: dict | None = None,
                 tenant_queue_cap: int | None = None,
                 tenant_inflight_cap: int | None = None,
                 node: str | None = None,
                 result_cache=None):
        # fleet identity: the member name a router knows this daemon by
        # (empty for a standalone daemon); surfaced in healthz/metrics so
        # node-labeled fleet dashboards can be cross-checked per worker
        self.node = str(node or os.environ.get("CCT_SERVE_NODE") or "")
        self.queue_bound = int(queue_bound)
        self.gang_size = max(1, int(gang_size))
        if str(device) not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        self.device = str(device)
        self.max_batch = int(max_batch)
        if result_ttl_s is None:
            result_ttl_s = float(os.environ.get("CCT_SERVE_RESULT_TTL_S", "600"))
        self.result_ttl_s = float(result_ttl_s)
        if result_max is None:
            result_max = int(os.environ.get("CCT_SERVE_RESULT_MAX", "512"))
        self.result_max = max(1, int(result_max))
        self._expired_cap = max(64, 4 * self.result_max)
        if isinstance(journal, str):
            journal = journal_mod.Journal(
                journal, max_bytes=int(os.environ.get(
                    "CCT_SERVE_JOURNAL_MAX_BYTES", str(1 << 20))))
        self._journal = journal
        self.counters = Counters()
        # fleet content-addressed result cache: a ResultCache instance or
        # a cache-plane root dir (str); None disables caching entirely
        if isinstance(result_cache, str):
            from consensuscruncher_tpu_torch.serve.result_cache import ResultCache
            result_cache = ResultCache(
                result_cache, node=self.node or None,
                max_bytes=int(os.environ.get(
                    "CCT_SERVE_CACHE_MAX_BYTES", "0")) or None,
                counters=self.counters)
        self.result_cache = result_cache
        weights = dict(self.DEFAULT_CLASS_WEIGHTS)
        for qos, w in (class_weights or {}).items():
            if qos not in weights:
                raise KeyError(f"unknown qos class {qos!r} in class_weights")
            w = float(w)
            if w <= 0:
                raise ValueError(f"class weight for {qos!r} must be > 0")
            weights[qos] = w
        self.class_weights = weights
        self.slo_targets = {qos: None for qos in QOS_CLASSES}
        for qos, t in (slo_targets or {}).items():
            if qos not in self.slo_targets:
                raise KeyError(f"unknown qos class {qos!r} in slo_targets")
            self.slo_targets[qos] = None if t is None else float(t)
        self.tenant_queue_cap = \
            None if tenant_queue_cap is None else max(1, int(tenant_queue_cap))
        self.tenant_inflight_cap = None if tenant_inflight_cap is None \
            else max(1, int(tenant_inflight_cap))
        self.slo = SloMonitor(targets=self.slo_targets)
        # optional callable set by the canary prober: {"ok", "age_s", ...}
        # surfaced in /metrics as the cct_canary_ok / cct_canary_age_s
        # gauges, read at /metrics time
        self.canary_info = None
        # recent gang-run intervals ({"t0", "t1", "jobs"}) for the
        # critpath antagonist view: "who was the dispatcher busy on while
        # this job sat queued".  Bounded; appended outside the lock's hot
        # path (once per gang)
        self._gang_log: deque = deque(maxlen=64)
        self._cond = sanitize.tracked_condition("scheduler.cond")
        # one FIFO per qos class; stride state drives weighted-fair picks
        self._queues: dict[str, deque[Job]] = \
            {qos: deque() for qos in QOS_CLASSES}
        self._stride = {qos: 1.0 / weights[qos] for qos in QOS_CLASSES}
        self._pass = {qos: 0.0 for qos in QOS_CLASSES}
        self._jobs: dict[int, Job] = {}
        self._by_key: dict[str, int] = {}
        self._expired: dict[int, dict] = {}  # evicted-job tombstones (FIFO)
        self._running: list[Job] = []
        self._draining = False
        self._paused = bool(paused)
        self._stop = False
        self._started_at = time.time()
        self._ewma_job_s: float | None = None
        # highest router epoch this worker has accepted; restored from the
        # journal's fence marker in _recover so a restart cannot be talked
        # into honoring a demoted router (0 = never fenced / no fleet HA)
        self._fence_epoch = 0
        # ---- failure containment (poison quarantine / brownout) knobs --
        # fleet-wide retry budget: max dispatch attempts for one key
        # across crashes, restarts, and (via the ring view) every
        # failover/adoption/steal path; 0 disables the budget
        self.max_fleet_attempts = int(
            os.environ.get("CCT_SERVE_MAX_FLEET_ATTEMPTS", "3"))
        # circuit breaker: this many quarantines inside the window from
        # one input fingerprint refuse that fault domain at admission
        self.breaker_quarantines = int(
            os.environ.get("CCT_SERVE_BREAKER_QUARANTINES", "3"))
        self.breaker_window_s = float(
            os.environ.get("CCT_SERVE_BREAKER_WINDOW_S", "300"))
        # resource watermarks (0 disables): queued spec bytes, process RSS
        self.queue_bytes_watermark = int(
            os.environ.get("CCT_SERVE_QUEUE_BYTES_WATERMARK", "0"))
        self.rss_watermark_mb = float(
            os.environ.get("CCT_SERVE_RSS_WATERMARK_MB", "0"))
        self._fleet_attempts: dict[str, int] = {}  # key -> dispatch count
        self._quarantined: dict[str, str] = {}     # key -> reason
        self._breaker_hits: dict[str, deque] = {}  # fingerprint -> times
        self._breaker_open_t: dict[str, float] = {}
        self._brownout = False
        self._thread = threading.Thread(
            target=self._loop, name="serve-dispatcher", daemon=True)
        if self._journal is not None:
            self._recover()
        if start:
            self._thread.start()

    # ----------------------------------------------------------- admission

    def submit(self, spec: dict) -> Job:
        job, _created = self.submit_info(spec)
        return job

    def submit_info(self, spec: dict,
                    trace: dict | None = None,
                    fleet_attempts: int | None = None) -> tuple[Job, bool]:
        """Admit a job; returns ``(job, created)``.  A duplicate submit
        (same idempotency key, job still tracked) returns the existing job
        with ``created=False`` instead of double-running the work.

        ``trace`` is the inbound wire trace context (client or router
        hop): the job adopts its trace id instead of minting, and the
        submit span records a ``follows_from`` edge to the sender — the
        causal chain survives the router hop instead of dying at it.

        ``fleet_attempts`` is the router-carried attempt lineage for the
        key (the ``attempts`` rider on a forwarded submit): max-merged
        into the local count BEFORE admission, so this node's budget
        gate — and the ``suspect`` ordinals it journals — continue the
        fleet-wide lineage instead of granting a fresh budget."""
        for req in ("input", "output"):
            if not spec.get(req):
                raise ValueError(f"job spec missing {req!r}")
        qos = str(spec.get("qos") or DEFAULT_QOS)
        if qos not in QOS_CLASSES:
            raise ValueError(
                f"unknown qos class {qos!r}; expected one of {QOS_CLASSES}")
        # vote-policy admission: normalize BEFORE the key is
        # computed — an explicit default ("majority") is stripped so it
        # hashes identically to an absent field (legacy-stable keys and
        # cache digests) — and unknown names are refused here with the
        # registry's ValueError (the server's typed bad_request reply)
        # rather than failing on a warm device mid-dispatch.
        if spec.get("policy") in ("", "majority"):
            spec.pop("policy", None)
        elif spec.get("policy") is not None:
            from consensuscruncher_tpu_torch.policies import get_policy

            get_policy(str(spec["policy"]))
        tenant = str(spec.get("tenant") or DEFAULT_TENANT)
        key = journal_mod.idempotency_key(spec)
        deadline_s = spec.get("deadline_s")
        deadline_s = None if deadline_s is None else float(deadline_s)
        # the trace_id rides in on the wire context (or is minted HERE,
        # before admission can refuse, so shed decisions and journal-write
        # failures are traceable too); an admitted Job adopts it for life
        ctx = trace if isinstance(trace, dict) else None
        trace_id = (ctx or {}).get("trace_id") or obs_trace.mint_trace_id()
        with obs_trace.span("serve.submit", trace_id=trace_id, link=ctx,
                            input=spec.get("input"), key=key,
                            tenant=tenant, qos=qos), self._cond:
            if fleet_attempts:
                self._fleet_attempts[key] = max(
                    self._fleet_attempts.get(key, 0), int(fleet_attempts))
            qreason = self._quarantined.get(key)
            if qreason is not None:
                raise QuarantineRefused(
                    f"key {key} is quarantined: {qreason}",
                    reason=qreason, key=key)
            existing = self._by_key.get(key)
            if existing is not None and existing in self._jobs:
                return self._jobs[existing], False
            if self._draining:
                raise AdmissionRefused("server is draining; not accepting jobs")
            self._breaker_check_locked(spec, tenant, key)
            self._quota_check_locked(tenant, qos)
            self._shed_check_locked(deadline_s, tenant, qos, spec=spec)
            self._watermark_check_locked(tenant, qos)
            self._evict_locked(time.monotonic())
            queued = self._queued_locked()
            if queued >= self.queue_bound:
                raise AdmissionRefused(
                    f"queue full ({queued}/{self.queue_bound})")
            job = Job(spec, key=key, deadline_s=deadline_s, trace_id=trace_id)
            # admission checks all passed: everything before this stamp is
            # the critpath "admit" segment
            job.stamp("admit")
            # the ack span's own wire context: echoed on the reply and
            # journaled below, so every later continuation (failover
            # resubmit, adoption) can follows_from this durable anchor
            job.trace_ctx = obs_trace.wire_context()
            if self._journal is not None:
                # the accepted record must be on disk BEFORE the job is
                # acknowledged: a refused-but-unjournaled submit is safe to
                # retry, an acknowledged-but-unjournaled one would be lost
                # by a crash
                try:
                    n = self._journal_append_guarded(
                        journal_mod.job_record(
                            job.id, "accepted", key=job.key, spec=job.spec,
                            deadline_s=job.deadline_s, trace_id=job.trace_id,
                            trace=job.trace_ctx))
                except OSError as e:
                    # disk full (or any filesystem failure) even after the
                    # cache's emergency eviction: flip into read-only
                    # brownout.  A committed cache entry IS durable —
                    # admitting a hit costs a file copy, not journal disk
                    # — so cache hits are the one admission class a
                    # brownout keeps serving (journal-less; their bytes
                    # already survive a crash in the store).
                    self._trip_brownout_locked(e)
                    if not self._cache_shed_bypass_locked(spec, tenant, qos):
                        self.counters.add("brownout_refusals")
                        raise BrownoutRefused(
                            f"journal write failed ({e}); daemon is in "
                            "read-only brownout (polls and cache hits "
                            "still served; admissions refused until "
                            "appends succeed)")
                    n = 0
                except Exception as e:
                    raise AdmissionRefused(
                        f"journal write failed ({e}); job not accepted")
                else:
                    if self._brownout:
                        # the probe append above succeeded: disk pressure
                        # is gone, leave brownout
                        self._brownout = False
                        obs_flight.record("brownout_cleared")
                        print("serve: journal append succeeded again; "
                              "leaving brownout", file=sys.stderr, flush=True)
                self.counters.add("journal_bytes", n)
            # journal-ack fsync done (or no journal: zero-width segment)
            job.stamp("journal")
            if sanitize.ledger_enabled():
                job._lock_wait0 = {
                    name: row["wait_us"]
                    for name, row in sanitize.ledger_snapshot().items()}
            self._enqueue_locked(job)
            self._jobs[job.id] = job
            self._by_key[key] = job.id
            self.counters.high_water("queue_depth_hwm", self._queued_locked())
            obs_metrics.inc("tenant_jobs_admitted",
                            tenant=job.tenant, qos=job.qos)
            self._cond.notify_all()
        # flush the ack span to the trace shard before acknowledging: an
        # acked job's submit span must survive a kill -9 exactly like its
        # journal record does (the trace-completeness invariant's anchor)
        job.stamp("ack")
        obs_trace.flush()
        # schedule point at the ack boundary: everything durable happened
        # under the lock above; the caller's acknowledgement is next
        sanitize.yield_point("serve.ack")
        return job, True

    # -------------------------------------------------- per-class queues

    def _queued_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _any_queued_locked(self) -> bool:
        return any(self._queues.values())

    def _enqueue_locked(self, job: Job) -> None:
        queue = self._queues[job.qos]
        if not queue:
            # a class waking from idle must not have banked credit while
            # asleep — clamp its pass forward to the current leader so it
            # gets its fair share from NOW, not a monopoly first
            active = [self._pass[q] for q in QOS_CLASSES if self._queues[q]]
            if active:
                self._pass[job.qos] = max(self._pass[job.qos], min(active))
        queue.append(job)

    def _quota_check_locked(self, tenant: str, qos: str) -> None:
        """Per-tenant admission quotas: a tenant may hold at most
        ``tenant_queue_cap`` queue slots and ``tenant_inflight_cap``
        queued+running jobs; past either the submit is refused (the
        per-tenant analogue of ``queue_bound`` backpressure)."""
        if self.tenant_queue_cap is None and self.tenant_inflight_cap is None:
            return
        if tenant == CANARY_TENANT:
            # the heartbeat probe must not consume (or be refused by) a
            # real tenant's quota — it rides scavenger qos and the queue
            # bound only
            return
        queued = sum(1 for q in self._queues.values()
                     for j in q if j.tenant == tenant)
        if self.tenant_queue_cap is not None \
                and queued >= self.tenant_queue_cap:
            obs_metrics.inc("tenant_jobs_quota_refused",
                            tenant=tenant, qos=qos)
            raise QuotaRefused(
                f"tenant {tenant!r} queue quota exhausted "
                f"({queued}/{self.tenant_queue_cap})")
        if self.tenant_inflight_cap is not None:
            inflight = queued + sum(
                1 for j in self._running if j.tenant == tenant)
            if inflight >= self.tenant_inflight_cap:
                obs_metrics.inc("tenant_jobs_quota_refused",
                                tenant=tenant, qos=qos)
                raise QuotaRefused(
                    f"tenant {tenant!r} in-flight quota exhausted "
                    f"({inflight}/{self.tenant_inflight_cap})")

    def _shed_check_locked(self, deadline_s: float | None,
                           tenant: str, qos: str,
                           spec: dict | None = None) -> None:
        """Deadline-aware admission: refuse work that cannot finish in time
        at the observed service rate (EWMA of per-job wall).  A job with no
        explicit deadline inherits its qos class SLO target (when one is
        configured).  The ``serve.shed`` fault site forces a shed for
        chaos tests.

        Digest-keyed bypass: a submit whose ``content_digest`` is already
        committed in the result cache costs a file copy, not a pipeline
        run — the EWMA that justified the shed does not apply, so it is
        admitted instead of refused (counted ``cache_shed_bypass``).  The
        cache probe happens only when a shed WOULD fire, so the unloaded
        admission path never pays a lookup."""
        try:
            faults.fault_point("serve.shed")
        except faults.FaultError as e:
            if self._cache_shed_bypass_locked(spec, tenant, qos):
                return
            self._count_shed_locked(tenant, qos)
            self._flight_shed(f"injected: {e}", tenant, qos)
            raise DeadlineShed(f"shed: {e}")
        effective = deadline_s if deadline_s is not None \
            else self.slo_targets[qos]
        if effective is None or self._ewma_job_s is None:
            return
        backlog = self._queued_locked() + len(self._running)
        eta = (backlog + 1) * self._ewma_job_s / max(1, self.gang_size)
        if eta > effective:
            if self._cache_shed_bypass_locked(spec, tenant, qos):
                return
            self._count_shed_locked(tenant, qos)
            self._flight_shed(f"eta {eta:.1f}s > deadline_s={effective:g} "
                              f"(backlog={backlog})", tenant, qos)
            raise DeadlineShed(
                f"shed: estimated completion {eta:.1f}s exceeds "
                f"deadline_s={effective:g} (backlog={backlog}, "
                f"ewma_job_s={self._ewma_job_s:.2f})")

    def _cache_shed_bypass_locked(self, spec: dict | None,
                                  tenant: str, qos: str) -> bool:
        """True when ``spec``'s content digest has a committed result-cache
        entry — the admission bypass for would-be sheds.  Returns False
        fast with no cache configured (existing shed behavior is
        untouched); any probe failure also answers False (the cache is an
        optimization, never an admission authority)."""
        if self.result_cache is None or not spec:
            return False
        from consensuscruncher_tpu_torch.serve import result_cache as rc_mod
        try:
            digest = rc_mod.content_digest(spec)
            if digest is None or self.result_cache.lookup(digest) is None:
                return False
        except Exception:
            return False
        self.counters.add("cache_shed_bypass")
        obs_trace.event("serve.cache_shed_bypass", tenant=tenant, qos=qos)
        return True

    def _count_shed_locked(self, tenant: str, qos: str) -> None:
        self.counters.add("jobs_shed")
        obs_metrics.inc("tenant_jobs_shed", tenant=tenant, qos=qos)
        self.slo.note(qos, shed=True)

    @staticmethod
    def _flight_shed(why: str, tenant: str, qos: str) -> None:
        """A shed is an anomaly worth a post-mortem: record it and dump the
        flight ring so the overload's lead-up survives the incident."""
        obs_flight.record("shed", why=why, tenant=tenant, qos=qos)
        obs_flight.dump(reason="shed")

    # ------------------------------------- poison quarantine / brownout

    #: watermark pressure at which each qos class starts shedding:
    #: scavenger first, interactive only when the watermark is breached
    _WATERMARK_SHED_AT = {"scavenger": 0.8, "batch": 0.9, "interactive": 1.0}

    @staticmethod
    def _fault_domain(spec: dict, tenant: str) -> str:
        """Breaker fingerprint: one crashing input must trip the breaker
        for every submit of that input regardless of output path — the
        content digest when computable, else tenant + input path."""
        from consensuscruncher_tpu_torch.serve import result_cache as rc_mod
        try:
            digest = rc_mod.content_digest(spec or {})
        except Exception:
            digest = None
        return digest or f"{tenant}:{(spec or {}).get('input')}"

    def _breaker_check_locked(self, spec: dict, tenant: str,
                              key: str) -> None:
        """Per-fault-domain circuit breaker: a fingerprint that produced
        ``breaker_quarantines`` quarantines inside the window is refused
        at admission — the poison input cannot even enter the queue.  An
        open breaker half-closes after one quiet window."""
        if not self._breaker_open_t:
            return
        fp = self._fault_domain(spec, tenant)
        opened = self._breaker_open_t.get(fp)
        if opened is None:
            return
        if time.monotonic() - opened > self.breaker_window_s:
            del self._breaker_open_t[fp]
            return
        reason = (f"circuit breaker open for fault domain {fp!r}: "
                  f"{self.breaker_quarantines} quarantine(s) within "
                  f"{self.breaker_window_s:g}s")
        raise QuarantineRefused(reason, reason=reason, key=key)

    def _breaker_note_locked(self, job: Job) -> None:
        """Record one quarantine against the job's fault domain; open the
        breaker when the window fills (``breaker_open`` + flight dump)."""
        if self.breaker_quarantines <= 0:
            return
        fp = self._fault_domain(job.spec, job.tenant)
        now = time.monotonic()
        hits = self._breaker_hits.setdefault(fp, deque())
        hits.append(now)
        while hits and now - hits[0] > self.breaker_window_s:
            hits.popleft()
        if len(hits) >= self.breaker_quarantines \
                and fp not in self._breaker_open_t:
            self._breaker_open_t[fp] = now
            self.counters.add("breaker_open")
            obs_flight.record("breaker_open", fingerprint=fp,
                              quarantines=len(hits),
                              window_s=self.breaker_window_s)
            obs_flight.dump(reason="breaker-open")

    def _watermark_check_locked(self, tenant: str, qos: str) -> None:
        """Resource-exhaustion shedding: when queued spec bytes or
        process RSS approach their watermark, shed admissions lowest
        class first (scavenger at 80%, batch at 90%, interactive only at
        100%) so memory pressure degrades throughput before the OOM
        killer picks for us.  ``serve.oom`` forces 100% pressure."""
        pressure = 0.0
        try:
            faults.fault_point("serve.oom")
        except faults.FaultError:
            pressure = 1.0
        if self.queue_bytes_watermark > 0 and pressure < 1.0:
            qbytes = sum(j.spec_bytes
                         for q in self._queues.values() for j in q)
            pressure = max(pressure, qbytes / self.queue_bytes_watermark)
        if self.rss_watermark_mb > 0 and pressure < 1.0:
            rss = _rss_mb()
            if rss is not None:
                pressure = max(pressure, rss / self.rss_watermark_mb)
        if pressure >= self._WATERMARK_SHED_AT[qos]:
            self.counters.add("watermark_sheds")
            self.slo.note(qos, shed=True)
            obs_flight.record("watermark_shed", qos=qos, tenant=tenant,
                              pressure=round(pressure, 3))
            obs_flight.dump(reason="watermark-shed")
            raise DeadlineShed(
                f"shed: resource watermark at {pressure:.0%} "
                f"(class {qos!r} sheds at "
                f"{self._WATERMARK_SHED_AT[qos]:.0%})")

    def _journal_append_guarded(self, rec: dict) -> int:
        """Append with the ENOSPC first responder: a failed append
        triggers one emergency result-cache eviction sweep (reclaiming
        cache bytes is the cheapest disk on the box) and one retry
        before the failure propagates.  ``serve.enospc`` injects the
        disk-full OSError chaos tests arm."""
        try:
            faults.fault_point("serve.enospc")
        except faults.FaultError as e:
            raise OSError(28, f"No space left on device (injected: {e})")
        try:
            return self._journal.append(rec)
        except OSError:
            if self.result_cache is None:
                raise
            try:
                evicted = self.result_cache.evict_to_budget(emergency=True)
            except Exception:
                evicted = []
            for ev in evicted:
                self.counters.add("cache_evictions")
                self.counters.add("cache_bytes", -int(ev.get("bytes", 0)))
            if not evicted:
                raise
            return self._journal.append(rec)

    def _trip_brownout_locked(self, err: Exception) -> None:
        if not self._brownout:
            self._brownout = True
            obs_flight.record("brownout", error=str(err))
            obs_flight.dump(reason="brownout")
            print(f"WARNING: serve: journal append failing ({err}); "
                  "entering read-only brownout (polls + cache hits only)",
                  file=sys.stderr, flush=True)

    def _predispatch_locked(self, job: Job) -> bool:
        """Budget gate + crash attribution, run just before a job's
        dispatch record.  Quarantines the job (returns True = do NOT
        dispatch) when its key is already quarantined or its fleet
        attempt budget is spent; otherwise fsyncs the ``suspect`` marker
        (key, attempt ordinal, node) FIRST, so a kill -9 during the run
        is attributable on replay."""
        key = job.key or ""
        reason = self._quarantined.get(key)
        if reason is not None:
            job.state = "quarantined"
            job.error = reason
            job.finished_t = time.monotonic()
            # rejected work still spent real queue time — critpath must
            # account for it, not just for dispatched jobs
            job.queue_wait_s = job.finished_t - job.submitted_t
            self._critpath_emit_locked(job)
            return True
        attempt = self._fleet_attempts.get(key, 0) + 1
        if self.max_fleet_attempts and attempt > self.max_fleet_attempts:
            self.counters.add("fleet_attempts_exhausted")
            self._quarantine_locked(
                job, f"fleet retry budget exhausted "
                     f"({attempt - 1}/{self.max_fleet_attempts} attempts)")
            return True
        self._fleet_attempts[key] = attempt
        if self._journal is not None:
            try:
                n = self._journal.append_marker(
                    "suspect", key=key, attempt=attempt,
                    node=self.node or None)
                self.counters.add("journal_bytes", n)
            except Exception as e:
                print(f"WARNING: suspect marker write failed ({e}); a "
                      "crash during this run will not be attributable",
                      file=sys.stderr, flush=True)
        return False

    def _quarantine_locked(self, job: Job, reason: str) -> None:
        """Poison containment: park the job in the near-terminal
        ``quarantined`` state — durable via a journal marker so replay
        and zombie restarts honor it — instead of letting another
        dispatch amplify a deterministic crasher.  Feeds the
        per-fingerprint circuit breaker."""
        key = job.key or ""
        job.state = "quarantined"
        job.error = reason
        job.finished_t = time.monotonic()
        job.queue_wait_s = job.finished_t - job.submitted_t
        self._quarantined[key] = reason
        self.counters.add("jobs_quarantined")
        if self._journal is not None:
            try:
                n = self._journal.append_marker(
                    "quarantined", key=key, reason=reason,
                    node=self.node or None)
                self.counters.add("journal_bytes", n)
            except Exception as e:
                print(f"WARNING: quarantine marker write failed ({e}); "
                      "the quarantine will not survive a restart",
                      file=sys.stderr, flush=True)
        obs_trace.event("serve.quarantine", trace_id=job.trace_id,
                        job_id=job.id, key=key, reason=reason)
        self._critpath_emit_locked(job)
        obs_flight.record("quarantine", job_id=job.id, key=key,
                          reason=reason, tenant=job.tenant, qos=job.qos)
        obs_flight.dump(reason="quarantine")
        self._breaker_note_locked(job)
        self._cond.notify_all()

    def release_quarantine(self, key: str) -> dict:
        """``cct route --release KEY``: lift a key's quarantine, zero its
        fleet attempt lineage, and re-queue the parked job (if still
        tracked).  Journaled (``quarantined`` marker with ``released``)
        so the release survives restarts."""
        key = str(key)
        with self._cond:
            reason = self._quarantined.pop(key, None)
            if reason is None:
                return {"released": False, "key": key}
            self._fleet_attempts.pop(key, None)
            if self._journal is not None:
                try:
                    n = self._journal.append_marker(
                        "quarantined", key=key, released=True,
                        node=self.node or None)
                    self.counters.add("journal_bytes", n)
                except Exception as e:
                    print(f"WARNING: release marker write failed ({e}); "
                          "the release will not survive a restart",
                          file=sys.stderr, flush=True)
            self.counters.add("quarantine_released")
            job_id = self._by_key.get(key)
            job = self._jobs.get(job_id) if job_id is not None else None
            requeued = False
            if job is not None and job.state == "quarantined":
                job.state = "queued"
                job.error = None
                job.finished_t = None
                job.submitted_t = time.monotonic()
                # the release restarts the job's clock; stale boundary
                # stamps from the quarantined life would corrupt critpath
                job.stamps = {}
                job.queue_wait_s = None
                self._enqueue_locked(job)
                requeued = True
                self._cond.notify_all()
            obs_flight.record("quarantine_released", key=key,
                              requeued=requeued)
            return {"released": True, "key": key, "requeued": requeued}

    def quarantined_keys(self) -> dict[str, str]:
        with self._cond:
            return dict(self._quarantined)

    def fleet_attempts(self, key: str) -> int:
        with self._cond:
            return self._fleet_attempts.get(str(key), 0)

    def note_fleet_attempts(self, key: str, attempts: int) -> None:
        """Fold a ring-view-carried attempt count for ``key`` into the
        local lineage (max-merge: lineages only ever grow) — how a
        router's failover resubmit hands the budget across nodes."""
        with self._cond:
            key = str(key)
            self._fleet_attempts[key] = max(
                self._fleet_attempts.get(key, 0), int(attempts))

    def get(self, job_id: int) -> Job | None:
        with self._cond:
            return self._jobs.get(int(job_id))

    def lookup(self, job_id=None, key: str | None = None):
        """Resolve a job by id or idempotency key, including evicted ones.
        Returns ``("job", Job)``, ``("expired", tombstone)`` or ``None``."""
        with self._cond:
            if job_id is None and key is not None:
                job_id = self._by_key.get(str(key))
                if job_id is None:
                    for info in self._expired.values():
                        if info["key"] == key:
                            return ("expired", dict(info))
                    return None
            if job_id is None:
                return None
            job_id = int(job_id)
            job = self._jobs.get(job_id)
            if job is not None:
                return ("job", job)
            info = self._expired.get(job_id)
            if info is not None:
                return ("expired", dict(info))
            return None

    def wait(self, job_id: int, timeout: float | None = None) -> Job:
        """Block until the job reaches a terminal state (or timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            job = self._jobs[int(job_id)]
            while job.state not in ("done", "failed", "quarantined"):
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(f"job {job.id} still {job.state}")
                self._cond.wait(timeout=remaining)
        return job

    # --------------------------------------------------------------- fencing

    def fence(self, epoch, router=None) -> None:
        """Epoch admission for router-forwarded requests.

        A forward whose epoch is *below* the highest accepted one is a
        zombie router's — reject it (``fencing_rejections``) by raising
        :class:`RouterFenced`.  A *higher* epoch means a takeover
        happened: adopt it and persist a journal ``fence`` marker so the
        floor survives a worker restart.  The ``route.fence`` fault site
        fires here (an armed fault is indistinguishable from a stale
        forward — the router-side demotion path runs for real)."""
        try:
            faults.fault_point("route.fence")
        except faults.FaultError as e:
            self.counters.add("fencing_rejections")
            raise RouterFenced(self.fence_epoch, f"injected: {e}")
        try:
            epoch = int(epoch)
        except (TypeError, ValueError):
            return  # epoch-less request: pre-HA router or direct client
        with self._cond:
            if epoch < self._fence_epoch:
                self.counters.add("fencing_rejections")
                who = f" from router {router!r}" if router else ""
                raise RouterFenced(
                    self._fence_epoch,
                    f"stale forward{who}: epoch {epoch} < accepted "
                    f"{self._fence_epoch}")
            if epoch > self._fence_epoch:
                self._fence_epoch = epoch
                # flight dumps carry the epoch this worker last honored
                obs_flight.set_identity(epoch=epoch)
                if self._journal is not None:
                    try:
                        n = self._journal.append_marker(
                            "fence", epoch=epoch,
                            router=None if router is None else str(router))
                        self.counters.add("journal_bytes", n)
                    except Exception as e:
                        print(f"WARNING: fence marker write failed ({e}); "
                              "the epoch floor will not survive a restart",
                              file=sys.stderr, flush=True)

    @property
    def fence_epoch(self) -> int:
        with self._cond:
            return self._fence_epoch

    # --------------------------------------------------------------- journal

    def _journal_update_locked(self, job: Job, state: str, **fields) -> None:
        """Journal a lifecycle transition.  Post-admission journal failures
        degrade durability, not availability: log and keep running (the
        job's manifest still proves completed stages on replay).

        Trace-completeness ordering: every transition record carries the
        job's ``trace_id``, and a *terminal* transition emits (and
        flushes) a ``serve.terminal`` trace event BEFORE the journal
        append — so "the journal proves the job terminal" implies "the
        trace has a durable terminal span", even under kill -9 right
        after the fsync."""
        if self._journal is None:
            return
        fields.setdefault("trace_id", job.trace_id)
        if state in ("done", "failed"):
            obs_trace.event("serve.terminal", trace_id=job.trace_id,
                            job_id=job.id, key=job.key, state=state)
            obs_trace.flush()
        try:
            n = self._journal_append_guarded(
                journal_mod.job_record(job.id, state, **fields))
        except Exception as e:
            if isinstance(e, OSError):
                # post-admission disk-full: durability degrades AND the
                # admission path must stop promising it — brownout
                self._trip_brownout_locked(e)
            print(f"WARNING: journal append ({state}, job {job.id}) "
                  f"failed: {e}", file=sys.stderr, flush=True)
            return
        self.counters.add("journal_bytes", n)
        self._maybe_rotate_locked()

    def _snapshot_records_locked(self) -> list[dict]:
        """One full-state record per tracked job, for checkpoint rotation,
        plus the marker state rotation must not lose: the fence floor,
        the per-key suspect lineage, and every quarantined key (a rotated
        journal that forgot a quarantine would re-dispatch the poison)."""
        to_journal = {"queued": "accepted", "running": "dispatched",
                      "quarantined": "accepted"}
        recs = []
        for jid in sorted(self._jobs):
            j = self._jobs[jid]
            recs.append(journal_mod.job_record(
                j.id, to_journal.get(j.state, j.state), key=j.key,
                spec=j.spec, deadline_s=j.deadline_s, outputs=j.outputs,
                error=j.error, wall_s=j.wall_s, trace_id=j.trace_id,
                trace=j.trace_ctx))
        if self._fence_epoch:
            recs.append({"v": 1, "rec": "marker", "kind": "fence",
                         "epoch": self._fence_epoch})
        for key in sorted(self._fleet_attempts):
            recs.append({"v": 1, "rec": "marker", "kind": "suspect",
                         "key": key,
                         "attempt": self._fleet_attempts[key],
                         **({"node": self.node} if self.node else {})})
        for key in sorted(self._quarantined):
            recs.append({"v": 1, "rec": "marker", "kind": "quarantined",
                         "key": key, "reason": self._quarantined[key],
                         **({"node": self.node} if self.node else {})})
        return recs

    def _maybe_rotate_locked(self) -> None:
        if self._journal is None or self._journal.max_bytes is None:
            return
        if self._journal.size() <= self._journal.max_bytes:
            return
        try:
            self._journal.rotate(self._snapshot_records_locked())
        except Exception as e:
            print(f"WARNING: journal rotation failed ({e}); appends continue "
                  "on the unrotated file", file=sys.stderr, flush=True)

    def _recover(self) -> None:
        """Replay the journal: re-enqueue every job not provably terminal.
        Each replayed job re-runs through the per-job manifest ``--resume``
        path, so completed stages are skipped and outputs stay
        byte-identical — exactly-once at the output level."""
        jobs, info = journal_mod.replay(self._journal.path)
        if info.get("crc_skipped"):
            # mid-file bit flips the replay refused to act on — surfaced
            # as a counter so a corrupted disk shows up in metrics, not
            # just a startup warning line
            self.counters.add("journal_crc_skipped", int(info["crc_skipped"]))
        requeued = finished = dropped = adopted = quarantined = 0
        with self._cond:
            if info.get("fence_epoch"):
                self._fence_epoch = max(self._fence_epoch,
                                        int(info["fence_epoch"]))
            # crash attribution survives the crash: suspect markers carry
            # the per-key attempt lineage, quarantined markers the parked
            # keys (max-merge / last-wins — both replay-idempotent)
            for k, n in (info.get("suspects") or {}).items():
                self._fleet_attempts[k] = max(
                    self._fleet_attempts.get(k, 0), int(n))
            self._quarantined.update(info.get("quarantined") or {})
            for jid in sorted(jobs):
                rec = jobs[jid]
                spec = rec.get("spec")
                if not isinstance(spec, dict) or not spec.get("input") \
                        or not spec.get("output"):
                    dropped += 1
                    print(f"WARNING: journal replay: job {jid} has no usable "
                          "spec (rotated-away accepted record?); dropping",
                          file=sys.stderr, flush=True)
                    continue
                if rec.get("adopted") \
                        and rec.get("state") not in ("done", "failed"):
                    # this journal was tombstoned while we were down: the
                    # job now lives on its ring successor.  Re-running it
                    # here is the zombie double-run the tombstone exists
                    # to prevent — drop it and count the fencing
                    adopted += 1
                    self.counters.add("fencing_rejections")
                    print(f"serve: journal replay: job {jid} was adopted by "
                          f"router {info.get('adopted_by')!r} while this "
                          "node was down; dropping (its ring successor "
                          "owns it now)", file=sys.stderr, flush=True)
                    continue
                job = Job(spec, job_id=jid,
                          key=rec.get("key") or journal_mod.idempotency_key(spec),
                          deadline_s=rec.get("deadline_s"),
                          trace_id=rec.get("trace_id"))
                ctx = rec.get("trace")
                job.trace_ctx = ctx if isinstance(ctx, dict) else None
                self._jobs[job.id] = job
                self._by_key[job.key] = job.id
                # migration shim: journals written before the v2 key
                # (version-pinned, input_range-aware) carry v1 keys.
                # Register the replayed job under every identity it has
                # ever had, so a client still polling the journaled key
                # AND a fresh dedupe on the recomputed key both resolve
                # to this job (setdefault: a live key never loses to an
                # alias).
                for alias in (journal_mod.idempotency_key(spec),
                              journal_mod.legacy_idempotency_key(spec)):
                    self._by_key.setdefault(alias, job.id)
                if rec.get("state") in ("done", "failed"):
                    job.state = rec["state"]
                    job.outputs = rec.get("outputs")
                    job.error = rec.get("error")
                    job.wall_s = rec.get("wall_s")
                    qc = rec.get("qc")
                    job.qc = qc if isinstance(qc, dict) else None
                    job.finished_t = time.monotonic()
                    finished += 1
                elif job.key in self._quarantined:
                    # the marker said it all: the job stays parked, polls
                    # keep answering, no dispatch until a release
                    job.state = "quarantined"
                    job.error = self._quarantined[job.key]
                    job.finished_t = time.monotonic()
                    quarantined += 1
                elif self.max_fleet_attempts and \
                        self._fleet_attempts.get(job.key, 0) \
                        >= self.max_fleet_attempts:
                    # suspect blame: this key was in flight at every one
                    # of its budgeted attempts and the process still died
                    # — quarantine NOW, before replay re-dispatches it
                    self.counters.add("suspect_blames")
                    self.counters.add("fleet_attempts_exhausted")
                    obs_flight.record(
                        "suspect_blamed", key=job.key, job_id=job.id,
                        attempts=self._fleet_attempts.get(job.key, 0))
                    self._quarantine_locked(
                        job, f"fleet retry budget exhausted "
                             f"({self._fleet_attempts.get(job.key, 0)}/"
                             f"{self.max_fleet_attempts} attempts; blamed "
                             "by replay crash attribution)")
                    quarantined += 1
                else:
                    if rec.get("state") == "dispatched" \
                            and self._fleet_attempts.get(job.key):
                        # crash attribution: the suspect marker proves
                        # this job was in flight when the process died
                        self.counters.add("suspect_blames")
                        obs_flight.record(
                            "suspect_blamed", key=job.key, job_id=job.id,
                            attempts=self._fleet_attempts[job.key])
                    # accepted or dispatched: not provably done -> re-run.
                    # The deadline clock restarts here — the daemon being
                    # down must not shed every queued job on every restart.
                    job.state = "queued"
                    job.submitted_t = time.monotonic()
                    self._enqueue_locked(job)
                    self.counters.add("jobs_replayed")
                    # stitch the restarted process onto the pre-crash
                    # trace: a follows_from edge back to the dead
                    # incarnation's durable ack span (persisted on the
                    # accepted record) keeps the job's span tree
                    # connected across kill -9 + replay
                    with obs_trace.span("serve.replay", trace_id=job.trace_id,
                                        link=job.trace_ctx, key=job.key,
                                        job_id=job.id):
                        job.trace_ctx = obs_trace.wire_context() \
                            or job.trace_ctx
                    requeued += 1
            self.counters.high_water("queue_depth_hwm", self._queued_locked())
            self._cond.notify_all()
        if requeued or finished or dropped or adopted or quarantined \
                or info["skipped"]:
            print(f"serve: journal replay: {requeued} job(s) re-enqueued, "
                  f"{finished} already terminal, "
                  f"{quarantined} quarantined, "
                  f"{adopted} adopted elsewhere, "
                  f"{dropped + info['skipped']} record(s) skipped"
                  + (" (previous shutdown was a clean drain)"
                     if info["clean_drain"] else ""),
                  file=sys.stderr, flush=True)
        if adopted:
            obs_flight.record("zombie_fenced", adopted_jobs=adopted,
                              adopted_by=info.get("adopted_by"))
        if (requeued or dropped or info["skipped"] or info["torn_tail"]) \
                and not info["clean_drain"]:
            # the previous daemon died uncleanly with work in flight: this
            # dump is the post-mortem a kill -9 itself could never write
            obs_flight.record(
                "journal_replay", requeued=requeued, finished=finished,
                skipped=dropped + info["skipped"],
                torn_tail=info["torn_tail"])
            obs_flight.dump(reason="journal-replay")

    # ------------------------------------------------------------- retention

    def _evict_locked(self, now: float) -> int:
        """Drop terminal jobs past the TTL or beyond ``result_max``; their
        outputs stay on disk and a bounded tombstone keeps ``result``
        replies informative."""
        terminal = [j for j in self._jobs.values()
                    if j.state in ("done", "failed")
                    and j.finished_t is not None]
        doomed = [j for j in terminal if now - j.finished_t > self.result_ttl_s]
        doomed_ids = {j.id for j in doomed}
        survivors = sorted((j for j in terminal if j.id not in doomed_ids),
                           key=lambda j: j.finished_t)
        over = len(survivors) - self.result_max
        if over > 0:
            doomed += survivors[:over]
        for j in doomed:
            del self._jobs[j.id]
            base = (j.outputs or {}).get("base") or job_paths(j.spec)["base"]
            self._expired[j.id] = {"job_id": j.id, "key": j.key,
                                   "final_state": j.state, "base": base}
            self.counters.add("evicted_jobs")
        while len(self._expired) > self._expired_cap:
            old_id = next(iter(self._expired))
            old = self._expired.pop(old_id)
            if self._by_key.get(old["key"]) == old_id:
                del self._by_key[old["key"]]
        return len(doomed)

    def evict_now(self) -> int:
        """Run one eviction pass immediately (tests, ops tooling)."""
        with self._cond:
            return self._evict_locked(time.monotonic())

    # ----------------------------------------------------- test/drain hooks

    def pause(self) -> None:
        with self._cond:
            self._paused = True

    def release(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def stop_admission(self) -> None:
        """Signal-safe drain entry: stop accepting, wake the dispatcher,
        return immediately (the bounded wait happens in the CLI's drain
        step, never inside a signal handler)."""
        with self._cond:
            self._draining = True
            self._paused = False
            self._cond.notify_all()

    def drain(self, timeout: float | None = None) -> None:
        """Stop admitting; block until queued + running work finishes."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._draining = True
            self._paused = False
            self._cond.notify_all()
            while self._any_queued_locked() or self._running:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError("drain timed out")
                self._cond.wait(timeout=remaining)

    def shutdown(self, timeout: float | None = 5.0) -> None:
        """Stop the dispatcher WITHOUT waiting for queued work — queued
        jobs stay journaled and replay on the next start."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def close(self, timeout: float | None = 60.0) -> None:
        try:
            self.drain(timeout=timeout)
        finally:
            self.shutdown(timeout=5.0)

    # ------------------------------------------------------------ critpath

    #: canonical boundary order; consecutive present stamps telescope into
    #: the segment chain obs/critpath.py renders
    _CRITPATH_ORDER = ("admit", "journal", "ack", "gang", "dispatch", "run")

    def _critpath_emit_locked(self, job: Job) -> None:
        """Emit the job's terminal ``serve.critpath`` event: boundary
        stamps as ms-from-submit offsets plus the queue-segment
        antagonist.  Raw evidence only — obs/critpath.py owns the
        decomposition math, so the event schema stays small and stable."""
        end = job.finished_t if job.finished_t is not None \
            else time.monotonic()
        stamps = {"submit": 0.0}
        for name in self._CRITPATH_ORDER:
            t = job.stamps.get(name)
            if t is not None:
                stamps[name] = round((t - job.submitted_t) * 1e3, 3)
        obs_trace.event(
            "serve.critpath", trace_id=job.trace_id, job_id=job.id,
            key=job.key, state=job.state, tenant=job.tenant, qos=job.qos,
            gang_size=job.gang_size, cached=job.cached,
            wall_ms=round((end - job.submitted_t) * 1e3, 3),
            queue_wait_ms=round((job.queue_wait_s or 0.0) * 1e3, 3),
            stamps=stamps, antagonist=self._antagonist_locked(job))

    def _antagonist_locked(self, job: Job) -> dict:
        """Who made this job wait: overlap of its queue window (ack ->
        gang pop) with recent gang runs names the dispatcher's victim
        jobs; the contention ledger's per-lock wait growth over the
        job's lifetime names the hottest lock (CCT_LOCK_LEDGER=1); the
        unexplained remainder is admission idle — the dispatcher was
        parked, nothing to blame but arrival order."""
        q0 = job.stamps.get("ack", job.submitted_t)
        q1 = job.stamps.get("gang")
        if q1 is None:
            q1 = job.finished_t if job.finished_t is not None \
                else time.monotonic()
        span = max(0.0, q1 - q0)
        busy = 0.0
        busiest_jobs: list[int] = []
        busiest_ov = 0.0
        for g in self._gang_log:
            ov = min(q1, g["t1"]) - max(q0, g["t0"])
            if ov <= 0:
                continue
            busy += ov
            if ov > busiest_ov:
                busiest_ov = ov
                busiest_jobs = list(g["jobs"])
        busy = min(busy, span)
        lock_name = None
        lock_wait_us = 0
        if job._lock_wait0 is not None:
            for name, row in sanitize.ledger_snapshot().items():
                d = row["wait_us"] - job._lock_wait0.get(name, 0)
                if d > lock_wait_us:
                    lock_wait_us = d
                    lock_name = name
        out = {"queue_ms": round(span * 1e3, 3),
               "dispatcher_busy_ms": round(busy * 1e3, 3),
               "idle_ms": round((span - busy) * 1e3, 3)}
        if busiest_jobs:
            out["busy_on_jobs"] = busiest_jobs[:8]
        if lock_name:
            out["lock"] = lock_name
            out["lock_wait_ms"] = round(lock_wait_us / 1e3, 3)
            holder = sanitize.current_holders().get(lock_name)
            if holder:
                out["lock_holder"] = holder
        # the dominant cause — what the fleet antagonist table keys on
        if span <= 0:
            out["kind"] = "none"
        elif busy >= span / 2:
            out["kind"] = "dispatcher"
        elif lock_wait_us / 1e6 >= span / 2:
            out["kind"] = "lock"
        else:
            out["kind"] = "idle"
        return out

    # ------------------------------------------------------------- metrics

    def metrics(self) -> dict:
        with self._cond:
            jobs = [j.describe() for j in self._jobs.values()]
            states = {s: sum(1 for j in self._jobs.values() if j.state == s)
                      for s in _STATES}
            cumulative = self.counters.snapshot()
            # recompiles live process-globally (the jit cache is per
            # process, not per Counters instance): folded in at read time
            cumulative["recompiles"] = obs_metrics.recompiles()
            # the trace plane owns its own tallies (spans/links/orphans
            # recorded by any thread, not just the scheduler): overlay
            # them so one metrics doc carries the whole process; same
            # for the profiler's sample/drop/shard tallies
            cumulative.update(obs_trace.counter_snapshot())
            cumulative.update(obs_prof.counter_snapshot())
            cumulative.update(obs_history.counter_snapshot())
            doc = metrics_doc(
                "serve", {"uptime": time.time() - self._started_at},
                {"n_jobs": len(jobs), "queue_bound": self.queue_bound,
                 "gang_size": self.gang_size, "draining": self._draining,
                 "brownout": self._brownout,
                 "quarantined_keys": len(self._quarantined),
                 "breakers_open": len(self._breaker_open_t),
                 "jobs_by_state": states},
                cumulative=cumulative,
            )
            doc["node"] = self.node
            doc["device"] = self.device
            # the hand kernels' launches in this process (the gangs' B1
            # dense launches among them), read where the wrappers count
            from consensuscruncher_tpu_torch.ops import consensus_vote

            doc["kernel_launches"] = {"vote": consensus_vote.launches,
                                      "vote_qc": consensus_vote.qc_launches,
                                      "fused": consensus_vote.fused_launches}
            doc["jobs"] = jobs
            doc["histograms"] = obs_metrics.histograms_snapshot()
            doc["labeled"] = obs_metrics.labeled_snapshot()
            # the lock-contention ledger composes in at READ time (never
            # via obs_metrics.inc — incrementing on every acquire would
            # put a metrics call on the hottest path in the process)
            if sanitize.ledger_enabled():
                led = sanitize.ledger_snapshot()
                if led:
                    lc = doc["labeled"].setdefault("counters", {})
                    for metric, field in (("lock_wait_us", "wait_us"),
                                          ("lock_hold_us", "hold_us"),
                                          ("lock_waits", "waits")):
                        lc[metric] = [
                            {"labels": {"lock": name}, "value": row[field]}
                            for name, row in led.items()]
            doc["slo"] = self.slo.snapshot()
            if self.canary_info is not None:
                try:
                    doc["canary"] = self.canary_info()
                except Exception:
                    pass  # telemetry must never take down /metrics
            doc["queued_by_class"] = \
                {qos: len(self._queues[qos]) for qos in QOS_CLASSES}
            doc["class_weights"] = dict(self.class_weights)
            if self._journal is not None:
                doc["journal"] = {"path": self._journal.path,
                                  "size_bytes": self._journal.size()}
            return doc

    def history_doc(self) -> dict:
        """Supplier for the :mod:`obs.history` recorder: the cumulative
        counters (deltas are taken on the history side) plus the gauges a
        delta cannot express."""
        m = self.metrics()
        gauges: dict = {
            "queued": sum((m.get("queued_by_class") or {}).values()),
            "n_jobs": m.get("n_jobs"),
        }
        canary = m.get("canary")
        if isinstance(canary, dict):
            gauges["canary_ok"] = 1 if canary.get("ok") else 0
            if canary.get("age_s") is not None:
                gauges["canary_age_s"] = canary["age_s"]
        return {"cum": m.get("cumulative") or {}, "gauges": gauges}

    def healthz(self) -> dict:
        with self._cond:
            return {
                "status": ("draining" if self._draining
                           else "brownout" if self._brownout
                           else "serving"),
                "node": self.node,
                "quarantined": len(self._quarantined),
                "queued": self._queued_locked(),
                "queued_by_class":
                    {qos: len(self._queues[qos]) for qos in QOS_CLASSES},
                "running": len(self._running),
                "uptime_s": round(time.time() - self._started_at, 3),
                "pid": os.getpid(),
                "fence_epoch": self._fence_epoch,
                "slo": self.slo.health(),
            }

    # ----------------------------------------------------------- dispatcher

    def _next_class_locked(self) -> str:
        """Stride pick: the backlogged class with the least accumulated
        virtual pass wins; registry class order breaks exact ties so the
        schedule is fully deterministic."""
        ready = [qos for qos in QOS_CLASSES if self._queues[qos]]
        return min(ready,
                   key=lambda qos: (self._pass[qos], QOS_CLASSES.index(qos)))

    def _pop_gang_locked(self) -> list[Job]:
        """Pop up to ``gang_size`` queued jobs sharing the compile-time
        consensus parameters (cutoff/qualscore/vote policy) from the
        stride-chosen qos class (gangs never span classes — fairness
        accounting stays exact).  Called under the lock."""
        qos = self._next_class_locked()
        queue = self._queues[qos]
        gang = [queue.popleft()]
        key = (float(gang[0].spec.get("cutoff", 0.7)),
               int(gang[0].spec.get("qualscore", 0)),
               str(gang[0].spec.get("policy") or "majority"))
        kept = deque()
        while queue and len(gang) < self.gang_size:
            job = queue.popleft()
            jkey = (float(job.spec.get("cutoff", 0.7)),
                    int(job.spec.get("qualscore", 0)),
                    str(job.spec.get("policy") or "majority"))
            if jkey == key:
                gang.append(job)
            else:
                kept.append(job)
        queue.extendleft(reversed(kept))
        # each dispatched job advances the class pass by one stride, so a
        # weight-8 class earns 8 dispatch slots per weight-1 slot
        self._pass[qos] += self._stride[qos] * len(gang)
        return gang

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._stop and \
                        (self._paused or not self._any_queued_locked()):
                    # parked time is the critpath "admission idle"
                    # denominator: queue waits that overlap neither a
                    # gang run nor a lock hold happened while the
                    # dispatcher had nothing to do
                    t_idle = time.monotonic()
                    self._cond.wait()
                    self.counters.add(
                        "dispatcher_idle_us",
                        int((time.monotonic() - t_idle) * 1e6))
                if self._stop:
                    return
                gang = self._pop_gang_locked()
                now = time.monotonic()
                live = []
                for job in gang:
                    # explicit deadline wins; otherwise the class SLO
                    # target acts as the implicit deadline (None = never)
                    effective = job.deadline_s if job.deadline_s is not None \
                        else self.slo_targets[job.qos]
                    if effective is not None and \
                            now - job.submitted_t > effective:
                        # dispatch-time shed: the deadline expired while the
                        # job sat in the queue; running it would waste device
                        # time on an answer nobody is waiting for
                        job.state = "failed"
                        job.error = (f"shed: deadline_s={effective:g} "
                                     f"expired after "
                                     f"{now - job.submitted_t:.1f}s in queue")
                        job.finished_t = now
                        # shed work carries its queue wait too — the whole
                        # point of critpath is accounting for the waits
                        # that did NOT end in a dispatch
                        job.queue_wait_s = now - job.submitted_t
                        self._count_shed_locked(job.tenant, job.qos)
                        self._critpath_emit_locked(job)
                        self._journal_update_locked(job, "failed",
                                                    error=job.error)
                    else:
                        # only survivors crossed the gang boundary: a shed
                        # job's critpath tail stays "queue" — it died
                        # waiting, it never joined a gang
                        job.stamps["gang"] = now
                        live.append(job)
                # budget gate: a quarantined (or budget-exhausted) job
                # must not reach another dispatch; survivors get their
                # suspect marker fsync'd before any work starts
                live = [job for job in live
                        if not self._predispatch_locked(job)]
                if not live:
                    self._cond.notify_all()
                    continue
                for job in live:
                    job.state = "running"
                    job.gang_size = len(live)
                    job.queue_wait_s = now - job.submitted_t
                    obs_metrics.observe("queue_wait_s", now - job.submitted_t)
                    obs_metrics.observe_labeled(
                        "tenant_queue_wait_s", now - job.submitted_t,
                        tenant=job.tenant, qos=job.qos)
                    self._journal_update_locked(job, "dispatched")
                    job.stamp("dispatch")
                self._running = list(live)
                self._cond.notify_all()
            t_busy = time.monotonic()
            try:
                self._run_gang(live)
            finally:
                t_end = time.monotonic()
                self.counters.add("dispatcher_busy_us",
                                  int((t_end - t_busy) * 1e6))
                with self._cond:
                    self._gang_log.append({"t0": t_busy, "t1": t_end,
                                           "jobs": [j.id for j in live]})
                    self._running = []
                    self._cond.notify_all()

    def _run_gang(self, gang: list[Job]) -> None:
        t0 = time.monotonic()
        # consult the content-addressed result cache BEFORE gang dispatch:
        # a hit job must not cost a single device batch.  The lookup is
        # purely an optimization — a cache IO failure degrades to
        # recomputing.
        hits: dict[int, dict] = {}
        for job in gang:
            entry = self._cache_lookup(job)
            if entry is not None:
                hits[job.id] = entry
        # range-sharded sub-jobs run solo through the CLI (the gang reader
        # consumes whole inputs; ``--input_range`` only exists down the
        # one-shot path), and cache hits must not cost a device batch
        live = [j for j in gang
                if j.id not in hits and not j.spec.get("input_range")]
        if len(live) > 1:
            try:
                faults.fault_point("serve.dispatch")
                with obs_trace.span("serve.gang", n_jobs=len(live),
                                    trace_id=live[0].trace_id):
                    handoffs = gang_sscs([j.spec for j in live], self.counters,
                                         max_batch=self.max_batch,
                                         trace_ids=[j.trace_id for j in live],
                                         device=self.device)
                for j, h in zip(live, handoffs):
                    j._stream_handoff = h
            except Exception as e:
                # Gang failure granularity is the gang: fall back to solo
                # runs — each job's resume path re-runs whatever its own
                # (atomically committed) outputs can't prove done.
                print(f"WARNING: serve gang dispatch failed ({e}); "
                      "running jobs solo", file=sys.stderr, flush=True)
        for job in gang:
            jt0 = t0 if len(gang) > 1 else time.monotonic()
            job.stamps["run"] = jt0
            try:
                with obs_trace.span("serve.job", trace_id=job.trace_id,
                                    job_id=job.id, tenant=job.tenant,
                                    qos=job.qos, cached=job.id in hits,
                                    queue_wait_ms=round(
                                        (job.queue_wait_s or 0.0) * 1e3, 3)):
                    if job.id in hits:
                        self._cache_materialize(job, hits[job.id])
                    else:
                        self._run_job(job)
                outcome = "done"
            except Exception as e:
                job.error = f"{type(e).__name__}: {e}"
                outcome = "failed"
                # unhandled worker death (retries exhausted): dump the ring
                # while the evidence — fault firings, retry lineage — is
                # still in memory
                obs_flight.record("worker_death", job_id=job.id,
                                  trace_id=job.trace_id, error=job.error,
                                  tenant=job.tenant, qos=job.qos)
                obs_flight.dump(reason="worker-death")
            if outcome == "done" and job.id not in hits:
                self.aggregate_job_metrics(job)
                self._cache_insert(job)
            if outcome == "done":
                # cache hits carry a qc.json too (it is part of the
                # materialized payload) — quality attribution must not
                # have a hit-shaped hole
                self.aggregate_job_qc(job)
            with self._cond:
                # gang jobs count from dispatch start: the shared SSCS wall
                # belongs to every member's end-to-end latency
                job.wall_s = round(time.monotonic() - jt0, 6)
                obs_metrics.observe("job_wall_s", job.wall_s)
                # the tenant-facing latency (and what SLO targets are
                # judged against) includes queue wait: submit -> terminal
                latency = time.monotonic() - job.submitted_t
                obs_metrics.observe_labeled(
                    "tenant_job_wall_s", latency,
                    tenant=job.tenant, qos=job.qos)
                obs_metrics.inc(
                    "tenant_jobs_done" if outcome == "done"
                    else "tenant_jobs_failed",
                    tenant=job.tenant, qos=job.qos)
                self.slo.note(job.qos, wall_s=latency)
                job.state = outcome
                if outcome == "done":
                    # a finished key's attempt lineage is dead weight —
                    # only still-failing keys keep consuming budget
                    self._fleet_attempts.pop(job.key or "", None)
                job.finished_t = time.monotonic()
                self._ewma_job_s = job.wall_s if self._ewma_job_s is None \
                    else 0.8 * self._ewma_job_s + 0.2 * job.wall_s
                # the critpath event rides the terminal flush below: a
                # journaled-terminal job always has durable stamps
                self._critpath_emit_locked(job)
                self._journal_update_locked(
                    job, outcome, outputs=job.outputs, error=job.error,
                    wall_s=job.wall_s, qc=job.qc)
                self._evict_locked(time.monotonic())
                self._cond.notify_all()

    # ------------------------------------------- content-addressed cache

    def _cache_lookup(self, job: Job):
        """Find a committed cache entry for this job's content digest.
        Counts hits/misses (misses only for cacheable jobs — an
        unfingerprintable input is not a miss, it is about to be a real
        error).  A cache IO error degrades to a miss: the cache is an
        optimization."""
        if self.result_cache is None:
            return None
        from consensuscruncher_tpu_torch.serve import result_cache as rc_mod
        try:
            digest = rc_mod.content_digest(job.spec)
            if digest is None:
                return None
            entry = self.result_cache.lookup(digest)
        except (OSError, ValueError) as e:
            print(f"WARNING: serve: cache lookup failed ({e}); recomputing",
                  file=sys.stderr, flush=True)
            return None
        if entry is None:
            self.counters.add("cache_misses")
            return None
        return entry

    def _cache_materialize(self, job: Job, entry: dict) -> None:
        """Serve a job straight from a committed cache entry: copy the
        payload into the job's own output tree (every file through
        ``commit_file``) and mark it done.  Raises on failure — the
        caller's normal failed-job path applies (the entry's payload is
        immutable, so a partial materialize never corrupts the store)."""
        base = job_paths(job.spec)["base"]
        n = self.result_cache.materialize(entry, base)
        job.outputs = {"base": base}
        job.cached = True
        self.counters.add("cache_hits")
        if entry.get("negative"):
            self.counters.add("cache_negative_hits")
        obs_trace.event("serve.cache_hit", trace_id=job.trace_id,
                        job_id=job.id, digest=entry.get("digest"),
                        bytes=n, negative=bool(entry.get("negative")))

    def _cache_insert(self, job: Job) -> None:
        """Commit a finished job's outputs as a cache entry (idempotent;
        best-effort — a failed insert costs a future hit, nothing else).
        A run that produced zero consensus families is flagged negative
        so known-empty work (an empty ``--input_range`` slice) is counted
        as such on later hits."""
        if self.result_cache is None:
            return
        from consensuscruncher_tpu_torch.serve import result_cache as rc_mod
        try:
            digest = rc_mod.content_digest(job.spec)
            if digest is None or not job.outputs:
                return
            entry = self.result_cache.insert(
                digest, job.outputs["base"],
                negative=self._job_is_negative(job),
                meta={"key": job.key, "node": self.node or None})
        except (OSError, ValueError) as e:
            print(f"WARNING: serve: cache insert failed ({e}); "
                  "result still served from the job's own outputs",
                  file=sys.stderr, flush=True)
            return
        if entry is None:
            return
        self.counters.add("cache_inserts")
        self.counters.add("cache_bytes", int(entry.get("bytes", 0)))
        for ev in self.result_cache.evict_to_budget():
            self.counters.add("cache_evictions")
            self.counters.add("cache_bytes", -int(ev.get("bytes", 0)))

    def _job_is_negative(self, job: Job) -> bool:
        """True when the job's own metrics sidecar proves zero consensus
        families came out — the cacheable-negative condition."""
        sidecar = f"{job_paths(job.spec)['sscs_prefix']}.metrics.json"
        try:
            with open(sidecar) as fh:
                cum = json.load(fh).get("cumulative", {})
        except (OSError, ValueError):
            return False
        return int(cum.get("families_out", -1)) == 0

    def _argv(self, spec: dict, resume: bool) -> list[str]:
        argv = [
            "consensus",
            "--input", spec["input"],
            "--output", spec["output"],
            "--cutoff", repr(float(spec.get("cutoff", 0.7))),
            "--qualscore", str(int(spec.get("qualscore", 0))),
            "--scorrect", str(bool(spec.get("scorrect", True))),
            "--max_mismatch", str(int(spec.get("max_mismatch", 0))),
            "--device", self.device,
            "--bdelim", spec.get("bdelim", "|"),
            "--compress_level", str(int(spec.get("compress_level", 6))),
        ]
        if spec.get("name"):
            argv += ["--name", spec["name"]]
        if spec.get("input_range"):
            # sub-job sharding: the range string rides the spec verbatim;
            # the CLI's manifest records it per stage, so overlapping
            # resubmits reuse committed outputs via RunManifest.can_skip
            argv += ["--input_range", str(spec["input_range"])]
        if spec.get("pipeline"):
            argv += ["--pipeline", str(spec["pipeline"])]
        if spec.get("policy"):
            # absent == majority (admission normalized the default away)
            argv += ["--policy", str(spec["policy"])]
        if "intermediate_taps" in spec:
            argv += ["--intermediate_taps", str(bool(spec["intermediate_taps"]))]
        if resume:
            argv += ["--resume", "True"]
        return argv

    def _run_job(self, job: Job) -> None:
        """Finish one job via the one-shot CLI with ``--resume`` (skips any
        stage the gang already recorded), retried with backoff on failure.
        The ``serve.worker`` fault site fires at each attempt's top."""
        from consensuscruncher_tpu_torch import cli

        def ran(rc):
            # the port's main returns the run's result dict; an int is an
            # exit code
            if isinstance(rc, int) and rc != 0:
                raise RuntimeError(f"consensus exited rc={rc}")

        attempts = int(os.environ.get("CCT_SERVE_RETRIES", "1")) + 1
        base = float(os.environ.get("CCT_RETRY_BASE_S", "0.5"))
        argv = self._argv(job.spec, resume=True)
        # Streaming jobs: the first attempt runs the streaming chain (with
        # the gang's in-memory SSCS hand-off when the dispatch produced
        # one); --resume retries always take the staged path — the CLI's
        # own streaming guard enforces that, this loop just stops passing
        # the hand-off, whose memory is released after the first use.
        streaming = str(job.spec.get("pipeline", "")) == "streaming"
        handoff = getattr(job, "_stream_handoff", None) if streaming else None
        job._stream_handoff = None
        for attempt in range(attempts):
            job.attempts += 1
            try:
                faults.fault_point("serve.worker")
                if "poison" in str(job.spec.get("name") or ""):
                    # poison-labeled jobs only: a fleet-wide armed
                    # ``serve.poison`` (kill/exit kinds) simulates one
                    # deterministically crashing input without touching
                    # honest jobs sharing the daemon
                    faults.fault_point("serve.poison")
                if streaming and attempt == 0:
                    ran(cli.main(self._argv(job.spec, resume=False),
                                 _sscs_handoff=handoff))
                    handoff = None
                else:
                    ran(cli.main(argv))
                job.outputs = {"base": job_paths(job.spec)["base"]}
                return
            except Exception as e:
                if attempt + 1 >= attempts:
                    raise
                self.counters.add("retries_fired")
                # retry lineage: attempt ordinal + error on the job's trace
                obs_trace.event("serve.retry", trace_id=job.trace_id,
                                job_id=job.id, attempt=attempt + 1,
                                error=f"{type(e).__name__}: {e}")
                obs_flight.record("retry", job_id=job.id, attempt=attempt + 1,
                                  trace_id=job.trace_id,
                                  error=f"{type(e).__name__}: {e}")
                delay = faults.backoff_delay(attempt + 1, base, 30.0)
                print(f"WARNING: serve job {job.id} attempt "
                      f"{attempt + 1}/{attempts} failed ({e}); retrying via "
                      f"--resume in {delay:.1f}s", file=sys.stderr, flush=True)
                time.sleep(delay)

    def aggregate_job_metrics(self, job: Job) -> None:
        """Fold a finished job's per-stage metrics sidecar into the daemon
        counters — the one-shot CLI and the daemon share one schema, so
        aggregation is literally reading the stage's own cumulative block."""
        sidecar = f"{job_paths(job.spec)['sscs_prefix']}.metrics.json"
        try:
            with open(sidecar) as fh:
                cum = json.load(fh).get("cumulative", {})
        except (OSError, ValueError):
            return
        for key in ("families_in", "families_out", "batches_dispatched"):
            self.counters.add(key, int(cum.get(key, 0)))

    #: qc.json yield key -> per-tenant labeled series (registry QC_SERIES)
    _QC_YIELD_SERIES = (
        ("families", "tenant_qc_families"),
        ("sscs_written", "tenant_qc_sscs_written"),
        ("singletons", "tenant_qc_singletons"),
        ("dcs_written", "tenant_qc_dcs_written"),
    )

    def aggregate_job_qc(self, job: Job) -> None:
        """Fold a finished job's ``qc.json`` into the daemon's per-tenant
        quality series, attach a compact summary to the job (describe() +
        journal done record), and mark the ``serve.job`` trace.  Best-
        effort: a pre-QC or CCT_QC=0 run simply has no doc."""
        if not job.outputs:
            return
        doc_path = os.path.join(job.outputs.get("base") or "", "qc.json")
        try:
            with open(doc_path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return
        if not isinstance(doc, dict):
            return
        yields = doc.get("yields") or {}
        rates = doc.get("rates") or {}
        plane = doc.get("plane") or {}
        disagree = plane.get("disagree_rate")
        # synthetic canary probes keep their qc summary (describe() +
        # prober verification) but never touch the per-tenant QC series —
        # a heartbeat must not move real quality attribution
        if job.tenant != CANARY_TENANT:
            rescued = (int(yields.get("rescued_by_sscs", 0))
                       + int(yields.get("rescued_by_singleton", 0)))
            for key, series in self._QC_YIELD_SERIES:
                obs_metrics.inc(series, int(yields.get(key, 0)),
                                tenant=job.tenant, qos=job.qos)
            obs_metrics.inc("tenant_qc_rescued", rescued,
                            tenant=job.tenant, qos=job.qos)
            # per-policy quality attribution: ``policy`` is a
            # CLOSED label — docs stamped with a name outside POLICY_NAMES
            # (a foreign plugin, a corrupt doc) skip the per-policy series
            # rather than widening the exposition or failing the job
            policy = str(doc.get("policy") or "majority")
            if policy in POLICY_NAMES:
                obs_metrics.inc("tenant_qc_policy_jobs", 1,
                                tenant=job.tenant, qos=job.qos,
                                policy=policy)
                obs_metrics.inc("tenant_qc_policy_sscs_written",
                                int(yields.get("sscs_written", 0)),
                                tenant=job.tenant, qos=job.qos,
                                policy=policy)
            if disagree is not None:
                obs_metrics.observe_labeled("tenant_qc_disagreement",
                                            float(disagree),
                                            tenant=job.tenant, qos=job.qos)
        job.qc = {"yields": {k: int(v) for k, v in yields.items()},
                  "rates": rates,
                  "disagree_rate": disagree,
                  "spectrum": doc.get("spectrum") or {}}
        self.counters.add("qc_docs_committed")
        obs_trace.event("serve.qc", trace_id=job.trace_id, job_id=job.id,
                        tenant=job.tenant, qos=job.qos,
                        families=int(yields.get("families", 0)),
                        sscs_written=int(yields.get("sscs_written", 0)),
                        dcs_written=int(yields.get("dcs_written", 0)),
                        disagree_rate=disagree)
