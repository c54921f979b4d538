"""Observability of the port (port of ``consensuscruncher_tpu/obs/``).

- :mod:`.registry` — the canonical names of the cumulative counters,
  histograms, labeled series and gauges (pure data);
- :mod:`.metrics` — fixed-bucket histograms, labeled per-tenant series,
  the transfer-byte and kernel-build counters, Prometheus rendering;
- :mod:`.trace` — correlation-id spans in per-thread rings, NDJSON shards
  under ``CCT_TRACE_DIR``, Chrome-trace export (``CCT_TRACE``);
- :mod:`.flight` — the flight recorder dumped on SIGQUIT and anomalies;
- :mod:`.slo` — per-qos-class SLO monitor (quantiles, burn rates);
- :mod:`.history` — durable telemetry history (``CCT_HISTORY_DIR``);
- :mod:`.prof` — the sampling profiler and span attribution (``CCT_PROF``);
- :mod:`.qc` — the consensus-quality (QC) document.

Import submodules directly; this package init stays empty.
"""
