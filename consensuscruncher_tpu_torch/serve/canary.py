"""Golden canary prober: active end-to-end correctness + latency watch.

Port of ``consensuscruncher_tpu/serve/canary.py``.  The probe is an
ordinary scavenger job of the daemon it watches, so its SSCS rides the
daemon's gang (B1's dense form on the card) and its finish the same
``consensus --resume`` path as a tenant's job.

Metrics notice a daemon that stops answering; nothing notices a daemon
that keeps answering *wrong* — silent correctness rot (a bad deploy, a
corrupted cache shard, a device numerics regression) only surfaces when
a tenant complains.  The prober closes that gap from inside the serve
plane: on a cadence it submits a tiny synthetic job (deterministic
``simulate_bam`` input, scavenger QoS, the reserved ``_canary`` tenant
that is excluded from tenant quotas and the QC series), waits for it,
and verifies the output BAM bytes against a pinned golden digest plus a
latency bound.  The first honest probe self-mints the golden (the input
is seeded, the pipeline is byte-deterministic — the digest is a
constant); ``CCT_CANARY_GOLDEN`` pins it explicitly, which is also the
ci positive control: a corrupted pin MUST flip the gauge.

A failed probe — digest mismatch, latency breach, or probe error —
flips the ``cct_canary_ok`` gauge to 0, counts ``canary_fail``, and
dumps the flight ring while the evidence is fresh.  An admission
refusal (the scavenger probe is the first thing shed under real
overload, by design) is a *skip*, not a failure: the canary watches for
rot, not for load.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import threading
import time

from consensuscruncher_tpu_torch.obs import flight as obs_flight
from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.serve.scheduler import (
    CANARY_TENANT,
    AdmissionRefused,
)

#: fixed simulation shape: tiny (8 fragments) so a probe costs
#: milliseconds of device time, seeded so the output bytes are constants
CANARY_SEED = 107
CANARY_FRAGMENTS = 8


def enabled() -> bool:
    return os.environ.get("CCT_CANARY", "") == "1"


def _interval_s() -> float:
    try:
        return max(0.5, float(os.environ.get("CCT_CANARY_INTERVAL_S",
                                             "60")))
    except ValueError:
        return 60.0


def _latency_s() -> float:
    try:
        return max(1.0, float(os.environ.get("CCT_CANARY_LATENCY_S",
                                             "120")))
    except ValueError:
        return 120.0


def output_digest(base: str) -> str:
    """sha256 over every output BAM's relative path + raw bytes (sorted
    walk).  BGZF layout is deterministic at a fixed compress level, so
    this is a constant for the seeded canary input — the sidecars
    (manifest, metrics, qc) carry walls and are deliberately excluded."""
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(base)):
        dirnames.sort()
        for name in sorted(filenames):
            if not name.endswith(".bam"):
                continue
            path = os.path.join(dirpath, name)
            h.update(os.path.relpath(path, base).encode())
            h.update(b"\0")
            try:
                with open(path, "rb") as fh:
                    for chunk in iter(lambda: fh.read(1 << 20), b""):
                        h.update(chunk)
            except OSError:
                h.update(b"<unreadable>")
            h.update(b"\0")
    return h.hexdigest()


class CanaryProber(threading.Thread):
    """Daemon thread probing ``scheduler`` on a cadence.  ``status()``
    is attached as ``scheduler.canary_info`` so /metrics exposes the
    gauges; ``probe_once()`` runs one synchronous probe (tests, ci)."""

    def __init__(self, scheduler, workdir: str,
                 interval_s: float | None = None,
                 latency_s: float | None = None,
                 golden: str | None = None):
        super().__init__(name="cct-canary", daemon=True)
        self.scheduler = scheduler
        self.workdir = workdir
        self.interval = interval_s if interval_s is not None \
            else _interval_s()
        self.latency_s = latency_s if latency_s is not None \
            else _latency_s()
        self.golden = golden \
            or os.environ.get("CCT_CANARY_GOLDEN", "") or None
        self.stop_event = threading.Event()
        self._lock = threading.Lock()
        self._ok = True
        self._last_done_t: float | None = None
        self._last_error: str | None = None
        self._runs = self._passes = self._fails = 0
        self._n = 0

    # ------------------------------------------------------------ status

    def status(self) -> dict:
        with self._lock:
            age = None if self._last_done_t is None \
                else round(time.monotonic() - self._last_done_t, 3)
            return {"ok": self._ok, "age_s": age, "runs": self._runs,
                    "pass": self._passes, "fail": self._fails,
                    "golden": self.golden, "last_error": self._last_error}

    # ------------------------------------------------------------- probe

    def _input_path(self) -> str:
        """The seeded synthetic input, simulated once per workdir."""
        path = os.path.join(self.workdir, "canary.bam")
        if not os.path.exists(path):
            from consensuscruncher_tpu_torch.utils.simulate import (
                SimConfig,
                simulate_bam,
            )
            os.makedirs(self.workdir, exist_ok=True)
            simulate_bam(path, SimConfig(n_fragments=CANARY_FRAGMENTS,
                                         seed=CANARY_SEED))
        return path

    def _fail(self, why: str) -> None:
        with self._lock:
            self._ok = False
            self._fails += 1
            self._last_error = why
            self._last_done_t = time.monotonic()
        self.scheduler.counters.add("canary_fail")
        obs_trace.event("serve.canary", ok=False, error=why)
        obs_flight.record("canary_fail", error=why,
                          golden=self.golden)
        obs_flight.dump(reason="canary-fail")

    def probe_once(self) -> bool | None:
        """One synchronous probe.  True = pass, False = fail, None =
        skipped (admission refused the scavenger probe — an overloaded
        daemon shedding the canary first is working as designed)."""
        self._n += 1
        out = os.path.join(self.workdir, f"run{self._n}")
        spec = {
            "input": self._input_path(), "output": out,
            "name": "canary", "tenant": CANARY_TENANT,
            "qos": "scavenger", "cutoff": 0.7, "qualscore": 0,
        }
        with self._lock:
            self._runs += 1
        self.scheduler.counters.add("canary_runs")
        t0 = time.monotonic()
        try:
            job, _created = self.scheduler.submit_info(spec)
        except AdmissionRefused as e:
            with self._lock:
                self._last_error = f"skipped: {e}"
            return None
        except Exception as e:
            self._fail(f"submit error: {type(e).__name__}: {e}")
            return False
        try:
            self.scheduler.wait(job.id, timeout=self.latency_s)
        except TimeoutError:
            self._fail(f"latency bound breached: probe still "
                       f"{job.state} after {self.latency_s:g}s")
            return False
        latency = time.monotonic() - t0
        if job.state != "done":
            self._fail(f"probe {job.state}: {job.error}")
            return False
        base = (job.outputs or {}).get("base") or out
        digest = output_digest(base)
        self._cleanup(keep=out)
        if self.golden is None:
            # first honest probe mints the golden: the seeded input and
            # byte-deterministic pipeline make the digest a constant
            self.golden = digest
        elif digest != self.golden:
            self._fail(f"golden digest mismatch: got {digest[:16]}.., "
                       f"want {self.golden[:16]}..")
            return False
        if latency > self.latency_s:
            self._fail(f"latency {latency:.1f}s > bound "
                       f"{self.latency_s:g}s")
            return False
        with self._lock:
            self._ok = True
            self._passes += 1
            self._last_error = None
            self._last_done_t = time.monotonic()
        self.scheduler.counters.add("canary_pass")
        obs_trace.event("serve.canary", ok=True,
                        latency_ms=round(latency * 1e3, 3))
        return True

    def _cleanup(self, keep: str) -> None:
        """Bound the probe scratch: drop every older run dir."""
        try:
            for name in sorted(os.listdir(self.workdir)):
                path = os.path.join(self.workdir, name)
                if name.startswith("run") and os.path.isdir(path) \
                        and os.path.abspath(path) != os.path.abspath(keep):
                    shutil.rmtree(path, ignore_errors=True)
        except OSError:
            pass

    # -------------------------------------------------------------- loop

    def run(self) -> None:
        while not self.stop_event.wait(self.interval):
            try:
                self.probe_once()
            except Exception as e:
                # the prober must never take down the daemon it watches
                self._fail(f"probe crashed: {type(e).__name__}: {e}")

    def stop(self, timeout: float = 2.0) -> None:
        self.stop_event.set()
        if self.is_alive():
            self.join(timeout)


def maybe_start(scheduler, workdir: str) -> CanaryProber | None:
    """Boot the prober iff ``CCT_CANARY=1``; attaches ``status`` to the
    scheduler's ``canary_info`` hook either way it starts."""
    if not enabled():
        return None
    prober = CanaryProber(scheduler, workdir)
    scheduler.canary_info = prober.status
    prober.start()
    return prober
