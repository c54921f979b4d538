"""Canonical names of the cumulative counters of the metrics sidecars.

The key set of ``CUMULATIVE_KEYS`` of ``consensuscruncher_tpu/obs/
registry.py``, in its order, so the port's ``cumulative`` blocks carry
the JAX package's keys (zero-filled by ``utils.profiling.Counters``, which
validates its keys against them).  The port counts ``families_in``,
``families_out``, ``batches_dispatched``, the pair votes, ``recompiles``,
``bytes_h2d``, ``bytes_d2h``, ``deflate_wall_us`` and
``bytes_bam_written``; the rest stay 0
until the serve plane, the router and the tracing tools are ported.  Help
text comes with the first reader of it (a metrics endpoint).
"""

CUMULATIVE_KEYS = (
    "families_in", "families_out", "batches_dispatched", "retries_fired",
    "queue_depth_hwm", "jobs_shed", "jobs_replayed", "evicted_jobs",
    "journal_bytes", "recompiles", "bytes_h2d", "bytes_d2h",
    "resident_pair_votes", "staged_pair_votes", "deflate_wall_us",
    "bytes_bam_written", "jobs_routed", "route_steals", "route_resubmits",
    "member_down_events", "route_locate_sweeps", "route_journal_answers",
    "router_failovers", "journals_adopted", "jobs_adopted",
    "fencing_rejections", "trace_spans_emitted", "trace_links",
    "trace_orphans", "prof_samples", "prof_drops", "prof_shards",
    "mc_interleavings", "mc_violations", "mc_deadlocks", "cache_hits",
    "cache_misses", "cache_negative_hits", "cache_inserts", "cache_evictions",
    "cache_bytes", "route_cache_answers", "cache_shed_bypass",
    "qc_docs_committed", "jobs_quarantined", "fleet_attempts_exhausted",
    "suspect_blames", "quarantine_released", "breaker_open",
    "brownout_refusals", "watermark_sheds", "qc_ranges_skipped",
    "wire_crc_errors", "wire_dup_dropped", "wire_timeouts", "conns_reaped",
    "journal_crc_skipped", "cache_integrity_misses", "history_snapshots",
    "history_bytes", "history_evictions", "canary_runs", "canary_pass",
    "canary_fail", "dispatcher_busy_us", "dispatcher_idle_us",
)
