"""Canonical metric-name registry: cumulative counters, histograms,
labeled series and gauges.

Port of ``consensuscruncher_tpu/obs/registry.py``: the same key names in
the same order (``CUMULATIVE_KEYS`` equals the reference's), so the
port's metrics sidecars and its serve ``metrics`` endpoint carry the JAX
package's schema.  Where a help text of the reference describes JAX (XLA
compiles, ``jnp.asarray`` uploads), the port's says what the port counts:
kernel-library builds (``ops.cuda_lib.build``) and the bytes that cross
to or from a CUDA card.

Pure data with zero imports:

- ``utils.profiling.Counters`` imports ``CUMULATIVE_KEYS`` to validate
  ``add()``/``high_water()`` keys (unknown names raise instead of
  silently minting a counter the metrics endpoint never publishes);
- ``obs.metrics`` builds its histogram hub from ``HISTOGRAMS`` and its
  labeled series from ``LABELED_COUNTERS``/``LABELED_HISTOGRAMS``.

To add a counter or histogram, add it here first; using an unregistered
name anywhere else is a runtime ``KeyError``.
"""

# name -> help text.  Folded into every metrics doc by
# ``Counters.snapshot`` (zero-filled), so the schema never varies with
# which code paths happened to run.
COUNTERS = {
    "families_in": "read families consumed from the grouped stream",
    "families_out": "consensus families emitted by the device stage",
    "batches_dispatched": "device batches dispatched (padded gangs count once)",
    "retries_fired": "worker attempts retried after an injected/real fault",
    "queue_depth_hwm": "high-water mark of the serve admission queue",
    "jobs_shed": "jobs refused or failed by deadline/overload shedding",
    "jobs_replayed": "jobs re-enqueued from the journal at daemon start",
    "evicted_jobs": "terminal jobs evicted from the in-memory registry",
    "journal_bytes": "bytes appended to the write-ahead journal",
    "recompiles": "kernel libraries compiled by nvcc in this process "
                  "(ops.cuda_lib.build; 0 once the build directory holds "
                  "them — the port has no per-shape JIT)",
    "bytes_h2d": "host->card bytes actually uploaded (measured, not "
                 "estimated; counted at every upload site, 0 on the CPU)",
    "bytes_d2h": "card->host bytes actually downloaded (measured at every "
                 "download site, 0 on the CPU)",
    "resident_pair_votes": "duplex votes served from the device-resident "
                           "SSCS plane store (no plane re-upload)",
    "staged_pair_votes": "duplex votes that re-uploaded planes from host "
                         "BAM bytes (store miss, empty, or broken)",
    "deflate_wall_us": "wall microseconds spent in BGZF deflate (block "
                       "compression + compressed write), measured at the "
                       "writer layer — the quantity the streaming pipeline "
                       "exists to collapse",
    "bytes_bam_written": "compressed BGZF bytes written to BAM outputs "
                         "(headers, blocks and EOF markers included)",
    "jobs_routed": "submits the fleet router forwarded onto a worker "
                   "daemon (stolen and failover resubmits included)",
    "route_steals": "batch/scavenger submits the router steered away from "
                    "their ring-home node to a less-loaded one",
    "route_resubmits": "jobs the router resubmitted to a new ring owner "
                       "after their node died (worker journal dedup makes "
                       "each an exactly-once replay, not a double run)",
    "member_down_events": "fleet members the router marked down (transport "
                          "failure on a forward, or health-probe streak)",
    "route_locate_sweeps": "keyed polls the router answered by sweeping the "
                           "fleet after the ring owner said unknown-job (a "
                           "failover emptied the placement cache, or a "
                           "membership change moved the key's ring home "
                           "away from the node that ran it)",
    "route_journal_answers": "keyed polls answered straight from a down "
                             "member's journal: the job reached a terminal "
                             "state before its node was adopted, so no live "
                             "member knows the key but the journal record "
                             "(and the outputs on disk) are authoritative",
    "router_failovers": "standby routers that promoted themselves to active "
                        "after the live router stopped answering (each "
                        "bumps the ring-view epoch)",
    "journals_adopted": "dead members' journals replayed and tombstoned by "
                        "the router after the eviction horizon",
    "jobs_adopted": "non-terminal jobs resubmitted by key to a ring "
                    "successor during journal adoption (worker journal "
                    "dedup + --resume keep each exactly-once)",
    "fencing_rejections": "requests rejected by epoch fencing: a worker "
                          "refusing a stale router's forward, or a "
                          "returning zombie dropping its adopted "
                          "(tombstoned) jobs at replay",
    "trace_spans_emitted": "trace events recorded by this process's span "
                           "machinery (spans, instants and wire-context "
                           "links; 0 unless CCT_TRACE is on)",
    "trace_links": "cross-process follows_from links recorded — a span "
                   "that adopted an inbound wire trace context (router "
                   "forward, failover resubmit, steal, adoption) instead "
                   "of rooting a fresh trace",
    # the help text is the reference's word for word (the exposition is
    # compared); the checker it names is utils/trace_check.py here
    "trace_orphans": "HA continuation points (failover resubmit, journal "
                     "resubmit, adoption) that found NO stored trace "
                     "context to link from — each is a causal chain "
                     "severed at a hop and a trace_check --fleet failure "
                     "waiting to happen",
    "prof_samples": "stack samples taken by the CCT_PROF sampling "
                    "profiler (one per sampled thread per tick at "
                    "CCT_PROF_HZ; 0 unless CCT_PROF is on)",
    "prof_drops": "samples whose collapsed stack was dropped because the "
                  "bounded aggregate already held CCT_PROF_MAX_STACKS "
                  "distinct keys — counted, never silently absorbed",
    "prof_shards": "profile shard lines flushed to prof-<pid>.ndjson "
                   "under CCT_PROF_DIR (one line per flush interval "
                   "with pending samples)",
    "mc_interleavings": "distinct schedules executed by the interleaving "
                        "model checker (tools/model_check.py)",
    "mc_violations": "schedules on which the model checker found a "
                     "protocol-invariant violation or deadlock",
    "mc_deadlocks": "explored schedules that ended with no runnable task "
                    "(a real lock-ordering or lost-wakeup deadlock)",
    "cache_hits": "jobs answered from the content-addressed result cache "
                  "(router consult-before-dispatch and worker-side lookups "
                  "both count here; the job never reran)",
    "cache_misses": "cacheable jobs that found no committed entry and ran "
                    "the full pipeline",
    "cache_negative_hits": "cache hits on negative entries (a run that "
                           "provably produced zero consensus families, "
                           "e.g. an empty --input_range slice)",
    "cache_inserts": "result-cache entries committed after a successful "
                     "run (payload + entry doc, all via commit_file)",
    "cache_evictions": "result-cache entries evicted to stay under the "
                       "configured byte budget (oldest first)",
    "cache_bytes": "payload bytes currently resident in this process's "
                   "result-cache shard (recounted at insert/evict)",
    "route_cache_answers": "router submits answered straight from the "
                           "result cache without dispatching to a worker "
                           "(journaled like a terminal journal-answer so "
                           "keyed polls survive a router kill -9)",
    "cache_shed_bypass": "submits the deadline/SLO shed path admitted "
                         "anyway because their content_digest was already "
                         "committed in the result cache (the answer is a "
                         "materialize, never a rerun — shedding it would "
                         "refuse free work)",
    "qc_docs_committed": "per-run qc.json documents committed via "
                         "manifest.commit_file (one per consensus run "
                         "with QC accumulation enabled)",
    "jobs_quarantined": "jobs parked in the quarantined state (fleet "
                        "retry budget exhausted, or blamed by replay "
                        "crash attribution) — durable via the journal's "
                        "quarantined marker until released",
    "fleet_attempts_exhausted": "redispatch attempts (failover resubmit, "
                                "adoption, journal recovery, steal, or a "
                                "worker predispatch) refused because the "
                                "key's fleet-wide attempt lineage hit "
                                "CCT_SERVE_MAX_FLEET_ATTEMPTS",
    "suspect_blames": "journal replays that blamed a key for the crash "
                      "via its pre-dispatch suspect marker (the job was "
                      "in flight when the process died)",
    "quarantine_released": "quarantined keys re-opened by an operator "
                           "release (cct route --release KEY)",
    "breaker_open": "fault-domain circuit-breaker trips: N quarantines "
                    "inside the window from one tenant/input "
                    "fingerprint made admission refuse that "
                    "fingerprint early",
    "brownout_refusals": "admissions refused because the daemon is in "
                         "resource-exhaustion brownout (journal appends "
                         "failing ENOSPC; polls and cache hits still "
                         "served)",
    "watermark_sheds": "admissions shed by the RSS/queue-byte resource "
                       "watermark (scavenger first, then batch, then "
                       "interactive)",
    "qc_ranges_skipped": "--input_range slices skipped at plan time "
                         "because the result cache held a negative entry "
                         "for the exact sub-spec (known-empty range, "
                         "nothing to run)",
    "wire_crc_errors": "wire frames dropped because their crc envelope "
                       "did not match the payload (corrupted in flight; "
                       "the peer re-requests instead of parsing garbage)",
    "wire_dup_dropped": "duplicated wire frames answered from the "
                        "per-connection seq replay cache instead of being "
                        "re-dispatched (duplicate delivery absorbed below "
                        "the idempotency layer)",
    "wire_timeouts": "wire requests that hit a read/forward deadline "
                     "(slow or blackholed peer) and were abandoned",
    "conns_reaped": "server connections reaped by the read/idle deadline "
                    "(half-open, slowloris, or silent peers; their "
                    "max_conns slot is recovered)",
    "journal_crc_skipped": "journal records skipped at replay because "
                           "their crc32 field did not match the record "
                           "bytes (mid-file corruption; torn tails are "
                           "counted separately)",
    "cache_integrity_misses": "result-cache lookups degraded to a miss "
                              "because a payload file failed its stored "
                              "sha256 (the corrupt entry dir is "
                              "quarantined, never served)",
    "history_snapshots": "labeled-snapshot delta lines appended to "
                         "history-<pid>.ndjson shards under "
                         "CCT_HISTORY_DIR (one per recorder interval "
                         "with pending deltas)",
    "history_bytes": "bytes appended to this process's history shard "
                     "(the quantity the retention budget meters)",
    "history_evictions": "whole history shards unlinked by the "
                         "CCT_HISTORY_MAX_BYTES retention budget "
                         "(oldest shard first, never the live one)",
    "canary_runs": "synthetic golden canary probes submitted by the "
                   "serve-side prober (scavenger qos, excluded from "
                   "tenant quotas and QC series)",
    "canary_pass": "canary probes whose outputs matched the pinned "
                   "golden digests byte-for-byte within the latency "
                   "bound",
    "canary_fail": "canary probes that failed: digest mismatch, "
                   "latency-bound breach, or a probe error — each flips "
                   "cct_canary_ok to 0 and dumps the flight ring",
    "dispatcher_busy_us": "microseconds the serve dispatcher thread "
                          "spent running gangs (the denominator's busy "
                          "half of the critpath dispatcher-idle ratio)",
    "dispatcher_idle_us": "microseconds the serve dispatcher thread "
                          "spent parked in cond.wait with no runnable "
                          "work (admission idle, from critpath's "
                          "antagonist view)",
}

CUMULATIVE_KEYS = tuple(COUNTERS)

# Latency buckets roughly log-spaced from 100 microseconds to 5 minutes;
# chosen once here so every exported histogram is cross-comparable.
_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

# Occupancy is a ratio in (0, 1]; fine buckets near 1.0 because padding
# waste is the quantity of interest.
_RATIO_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                  0.95, 1.0)

# ------------------------------------------------- tenancy / QoS labels
#
# The serve daemon is multi-tenant: every job carries a ``tenant`` id
# and a ``qos`` class.  Label *names* and the qos value set are closed
# here so exposition cardinality is bounded by construction; tenant is
# the one open-valued label and ``obs.metrics`` caps its live
# cardinality at runtime (CCT_OBS_MAX_TENANTS), folding overflow into
# ``OVERFLOW_TENANT``.

QOS_CLASSES = ("interactive", "batch", "scavenger")
# Closed set of consensus vote-policy names — the registered
# ``policies/`` built-ins.  Pure literal.
POLICY_NAMES = ("delegation", "distilled", "majority")
DEFAULT_TENANT = "default"
DEFAULT_QOS = "interactive"
# Sentinel tenant absorbing observations once the runtime tenant cap is
# hit — keeps exposition size bounded under tenant-id abuse.
OVERFLOW_TENANT = "__overflow__"

# label name -> {"closed": bool, "values": closed value set or None}.
# ``node`` is the fleet-router member name: open-valued like tenant, but
# its cardinality is bounded by the router's configured member list (a
# handful of daemons), so it needs no runtime cap.
LABELS = {
    "tenant": {"closed": False, "values": None},
    "qos": {"closed": True, "values": QOS_CLASSES},
    "node": {"closed": False, "values": None},
    "policy": {"closed": True, "values": POLICY_NAMES},
    # lock names come from utils.sanitize's tracked_lock/tracked_condition
    # call sites — open-valued like node, but bounded by the handful of
    # named locks the codebase declares (each is a source literal)
    "lock": {"closed": False, "values": None},
}

# Labeled counters are a separate namespace from COUNTERS: the global
# (unlabeled) series keep their exact names and byte layout, and the
# per-tenant series never collide with them in Prometheus exposition.
# name -> {"labels": label names (ordered), "help": ...}.
LABELED_COUNTERS = {
    "tenant_jobs_admitted": {
        "labels": ("tenant", "qos"),
        "help": "jobs accepted into the serve queue per tenant and class",
    },
    "tenant_jobs_done": {
        "labels": ("tenant", "qos"),
        "help": "jobs finished successfully per tenant and class",
    },
    "tenant_jobs_failed": {
        "labels": ("tenant", "qos"),
        "help": "jobs that reached the failed state per tenant and class",
    },
    "tenant_jobs_shed": {
        "labels": ("tenant", "qos"),
        "help": "jobs shed by deadline/SLO admission or dispatch expiry",
    },
    "tenant_jobs_quota_refused": {
        "labels": ("tenant", "qos"),
        "help": "submits refused by per-tenant queue or in-flight quotas",
    },
    # fleet-router series: counted in the ROUTER process (workers keep
    # their own per-process series; the router's metrics endpoint merges
    # both views into one node-labeled exposition)
    "node_jobs_routed": {
        "labels": ("node",),
        "help": "submits forwarded to each fleet member by the router",
    },
    "node_steals": {
        "labels": ("node",),
        "help": "stolen submits landed on each member (the thief side)",
    },
    "node_resubmits": {
        "labels": ("node",),
        "help": "failover resubmits landed on each member after another "
                "member died",
    },
    # consensus-quality (QC) series: folded in by the serve daemon from
    # each finished job's qc.json, so per-tenant data-plane quality rides
    # the same exposition as the system-plane series.  The full name set
    # is mirrored in QC_SERIES below.
    "tenant_qc_families": {
        "labels": ("tenant", "qos"),
        "help": "read families observed by finished jobs per tenant/class",
    },
    "tenant_qc_sscs_written": {
        "labels": ("tenant", "qos"),
        "help": "single-strand consensus reads emitted per tenant/class",
    },
    "tenant_qc_singletons": {
        "labels": ("tenant", "qos"),
        "help": "size-1 families routed to singleton handling per "
                "tenant/class",
    },
    "tenant_qc_dcs_written": {
        "labels": ("tenant", "qos"),
        "help": "duplex consensus reads emitted per tenant/class",
    },
    "tenant_qc_rescued": {
        "labels": ("tenant", "qos"),
        "help": "singletons rescued by SSCS/singleton correction per "
                "tenant/class",
    },
    # per-policy QC series: quality attribution by consensus
    # vote policy.  ``policy`` is a CLOSED label (POLICY_NAMES above), so
    # the per-policy exposition cardinality is bounded by construction.
    "tenant_qc_policy_jobs": {
        "labels": ("tenant", "qos", "policy"),
        "help": "finished jobs carrying a qc doc per tenant/class and "
                "consensus vote policy",
    },
    "tenant_qc_policy_sscs_written": {
        "labels": ("tenant", "qos", "policy"),
        "help": "single-strand consensus reads emitted per tenant/class "
                "and consensus vote policy",
    },
    # lock-contention ledger (critpath): per-named-lock wait/hold totals
    # from the TrackedLock/TrackedCondition timing in utils.sanitize,
    # composed into the metrics doc at read time (CCT_LOCK_LEDGER=1)
    "lock_wait_us": {
        "labels": ("lock",),
        "help": "microseconds threads spent blocked acquiring each "
                "named lock (contended acquires only pay the clock)",
    },
    "lock_hold_us": {
        "labels": ("lock",),
        "help": "microseconds each named lock was held between acquire "
                "and release (condition waits excluded from the hold)",
    },
    "lock_waits": {
        "labels": ("lock",),
        "help": "contended acquires per named lock (the fast-path "
                "uncontended acquire never counts here)",
    },
}

# Labeled histograms: per-(tenant, qos) series sharing the global
# latency buckets so the labeled and unlabeled views are comparable.
LABELED_HISTOGRAMS = {
    "tenant_job_wall_s": {
        "buckets": _LATENCY_BUCKETS,
        "unit": "seconds",
        "labels": ("tenant", "qos"),
        "help": "job wall time from submit to terminal state per tenant",
    },
    "tenant_queue_wait_s": {
        "buckets": _LATENCY_BUCKETS,
        "unit": "seconds",
        "labels": ("tenant", "qos"),
        "help": "admission to dispatch wait per tenant and class",
    },
    "tenant_qc_disagreement": {
        "buckets": _RATIO_BUCKETS,
        "unit": "ratio",
        "labels": ("tenant", "qos"),
        "help": "per-job mean vote-plane disagreement rate (votes that "
                "differed from the modal base / total votes), observed "
                "once per finished job carrying a qc doc",
    },
}

# The closed set of per-tenant QC series above (the reference's lint
# holds registered <=> emitted over this tuple).
QC_SERIES = (
    "tenant_qc_families",
    "tenant_qc_sscs_written",
    "tenant_qc_singletons",
    "tenant_qc_dcs_written",
    "tenant_qc_rescued",
    "tenant_qc_disagreement",
    "tenant_qc_policy_jobs",
    "tenant_qc_policy_sscs_written",
)

# Gauges: point-in-time values the metrics endpoint exposes outside the
# cumulative/histogram namespaces, declared here like the counters.
GAUGES = {
    "canary_ok": "1 while the last golden canary probe passed (digest "
                 "match + latency bound), 0 after a failure — the "
                 "fleet's end-to-end correctness heartbeat",
    "canary_age_s": "seconds since the last canary probe finished "
                    "(staleness guard: a green gauge nobody refreshed "
                    "is as alarming as a red one)",
}

# name -> {"buckets": upper bounds (le), "unit": ..., "help": ...}.
# ``obs.metrics`` zero-fills all of these in ``histograms_snapshot`` so
# the serve endpoint and bench sidecars always carry the full set.
HISTOGRAMS = {
    "queue_wait_s": {
        "buckets": _LATENCY_BUCKETS,
        "unit": "seconds",
        "help": "serve admission to gang dispatch wait per job",
    },
    "journal_fsync_s": {
        "buckets": _LATENCY_BUCKETS,
        "unit": "seconds",
        "help": "write-ahead journal append+fsync latency per record",
    },
    "device_dispatch_s": {
        "buckets": _LATENCY_BUCKETS,
        "unit": "seconds",
        "help": "device batch dispatch wall time (a first-use kernel "
                "build included)",
    },
    "batch_occupancy": {
        "buckets": _RATIO_BUCKETS,
        "unit": "ratio",
        "help": "real rows / padded capacity per emitted device batch",
    },
    "job_wall_s": {
        "buckets": _LATENCY_BUCKETS,
        "unit": "seconds",
        "help": "serve job wall time from dispatch to terminal state",
    },
}
