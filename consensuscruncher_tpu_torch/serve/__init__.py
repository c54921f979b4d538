"""serve/ — the persistent consensus daemon with cross-request batching.

Port of ``consensuscruncher_tpu/serve/`` (the daemon and its fleet).  A
one-shot CLI run pays the card's context creation, the kernel library's
load (and, on a cold build directory, its ``nvcc`` build) on every
invocation and leaves the card idle between samples.  The daemon pays
them once and packs families from several requests into one launch:

- :mod:`.server`    — long-lived daemon (unix socket or localhost TCP,
  newline-delimited JSON) exposing ``submit`` / ``status`` / ``result`` /
  ``healthz`` / ``metrics`` / ``drain``; started by the CLI's ``serve``.
- :mod:`.scheduler` — admission-controlled bounded job queue with
  continuous batching: families from several queued jobs are merged
  (``parallel.batching.interleave_sources``) into ONE dense device stream
  (``ops.consensus_dense.consensus_families``: B1's dense form), with
  per-job outputs byte-identical to the one-shot CLI path.
- :mod:`.warmup`    — the kernel build directory and one warm launch per
  configured bucket shape, so the first request never pays a cold build.
- :mod:`.client`    — blocking client used by ``submit`` and the tests;
  reconnects with capped backoff and polls by idempotency key, so a daemon
  restart is invisible to a waiting client.
- :mod:`.journal`   — write-ahead job journal (fsync'd NDJSON, atomic
  checkpoint rotation): every accepted job survives a daemon crash and
  replays byte-identically through ``--resume`` on restart.
- :mod:`.supervisor`— ``serve --supervise`` restart loop with capped
  exponential backoff for crashed daemons.
- :mod:`.wire`      — the optional seq/crc envelope of a wire frame.

- :mod:`.router`    — the fleet's front door: consistent-hash routing over
  N daemons, failover, stealing, HA (ring view, fencing, adoption).
- :mod:`.result_cache` — the content-addressed result cache plane.
- :mod:`.canary`    — the golden canary prober.
"""

from consensuscruncher_tpu_torch.serve.scheduler import (
    AdmissionRefused, DeadlineShed, Job, Scheduler,
)

__all__ = ["AdmissionRefused", "DeadlineShed", "Job", "Scheduler"]
