"""The port's golden canary against the JAX package's (CPU).

- ``output_digest`` equals the JAX function's on the same trees (BAMs
  only: a sidecar's wall does not move it, a BAM byte does).
- A real probe through a port daemon (``device="cpu"``: B1 dense's plain
  version) self-mints a golden and re-verifies it; that golden equals the
  JAX daemon's self-minted golden on the same seeded probe, and
  ``output_digest`` of a one-shot ``--device cpu`` run of the probe's
  input.
- A corrupted pinned golden flips ``ok`` and dumps the flight ring; an
  admission refusal is a skip; a submit error and a latency breach are
  failures; ``maybe_start`` gates on ``CCT_CANARY``; the canary tenant is
  quota-exempt — each as in the JAX package.
- The ``[obs]`` canary keys of ``-c config.ini`` fold into ``CCT_CANARY*``.
"""

import json
import os

import pytest

from consensuscruncher_tpu.obs import metrics as jax_metrics
from consensuscruncher_tpu.serve import canary as jax_canary
from consensuscruncher_tpu.serve import scheduler as jax_sched
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.obs import flight as torch_flight
from consensuscruncher_tpu_torch.obs import metrics as torch_metrics
from consensuscruncher_tpu_torch.serve import canary as torch_canary
from consensuscruncher_tpu_torch.serve import scheduler as torch_sched
from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_metrics():
    torch_metrics.reset_for_tests()
    jax_metrics.reset_for_tests()
    yield
    torch_metrics.reset_for_tests()
    jax_metrics.reset_for_tests()


def _sched(pkg, **kw):
    kw.setdefault("queue_bound", 16)
    kw.setdefault("gang_size", 1)
    if pkg == "port":
        return torch_sched.Scheduler(device="cpu", **kw)
    return jax_sched.Scheduler(backend="tpu", **kw)


CANARY = {"port": (torch_canary, torch_sched), "jax": (jax_canary, jax_sched)}


def _prober(pkg, sched, workdir, **kw):
    kw.setdefault("interval_s", 3600.0)
    kw.setdefault("latency_s", 120.0)
    return CANARY[pkg][0].CanaryProber(sched, str(workdir), **kw)


def test_output_digest_equals_jax(tmp_path):
    base = tmp_path / "out"
    (base / "sub").mkdir(parents=True)
    (base / "a.bam").write_bytes(b"bam-bytes")
    (base / "sub" / "b.bam").write_bytes(b"more")
    (base / "metrics.json").write_text('{"wall_s": 1.23}')
    seen = []
    for edit in (None, ("metrics.json", b'{"wall_s": 9.99}'), ("a.bam", b"rot")):
        if edit:
            (base / edit[0]).write_bytes(edit[1])
        got = torch_canary.output_digest(str(base))
        assert got == jax_canary.output_digest(str(base))
        seen.append(got)
    assert seen[0] == seen[1] != seen[2]
    assert torch_canary.output_digest(str(tmp_path / "none")) == \
        jax_canary.output_digest(str(tmp_path / "none"))


def test_probe_golden_equals_jax_and_a_one_shot_run(tmp_path):
    """Both daemons' first honest probes mint one golden; the port's
    second probe reproduces it; a one-shot ``--device cpu`` run of the
    probe's seeded input digests to it; the canary tenant never moves the
    per-tenant QC series."""
    goldens = {}
    for pkg in ("port", "jax"):
        sched = _sched(pkg, tenant_queue_cap=1, tenant_inflight_cap=1)
        try:
            prober = _prober(pkg, sched, tmp_path / pkg)
            assert prober.probe_once() is True
            goldens[pkg] = prober.golden
            if pkg == "port":
                assert prober.probe_once() is True and prober.golden == goldens[pkg]
                doc = prober.status()
                assert (doc["ok"], doc["pass"], doc["fail"], doc["runs"]) == (True, 2, 0, 2)
                assert sched.counters.snapshot()["canary_pass"] == 2
                labeled = (sched.metrics().get("labeled") or {}).get("counters") or {}
                for metric, rows in labeled.items():
                    if metric.startswith("tenant_qc"):
                        assert all(r["labels"].get("tenant") != torch_sched.CANARY_TENANT
                                   for r in rows), metric
        finally:
            sched.shutdown()
    assert goldens["port"] == goldens["jax"] and len(goldens["port"]) == 64
    probe = str(tmp_path / "probe.bam")
    simulate_bam(probe, SimConfig(n_fragments=torch_canary.CANARY_FRAGMENTS,
                                  seed=torch_canary.CANARY_SEED))
    with open(probe, "rb") as a, open(tmp_path / "port" / "canary.bam", "rb") as b:
        assert a.read() == b.read()
    torch_cli.main(["consensus", "-i", probe, "-o", str(tmp_path / "one"), "-n", "canary",
                    "--device", "cpu"])
    assert torch_canary.output_digest(str(tmp_path / "one" / "canary")) == goldens["port"]


def test_corrupted_golden_flips_ok_and_dumps_flight(tmp_path):
    dump_dir = tmp_path / "dumps"
    torch_flight.set_dump_dir(str(dump_dir))
    sched = _sched("port")
    try:
        prober = _prober("port", sched, tmp_path / "c", golden="deadbeef" * 8)
        assert prober.probe_once() is False
        doc = prober.status()
        assert doc["ok"] is False and doc["fail"] == 1 and "mismatch" in doc["last_error"]
        assert sched.counters.snapshot()["canary_fail"] == 1
        assert "cct_canary_ok 0" in torch_metrics.render_prometheus(
            dict(sched.metrics(), canary=prober.status()))
        dumps = sorted(n for n in os.listdir(dump_dir) if n.startswith("flight-"))
        with open(dump_dir / dumps[-1]) as fh:
            dumped = json.load(fh)
        assert dumped["reason"] == "canary-fail"
        assert any(ev.get("kind") == "canary_fail" for ev in dumped["events"])
    finally:
        torch_flight.set_dump_dir(None)
        sched.shutdown()


def _failure_modes(pkg, tmp_path, monkeypatch):
    mod, sched_mod = CANARY[pkg]
    seen = []
    sched = _sched(pkg)
    try:
        for exc in (sched_mod.AdmissionRefused("queue full"), RuntimeError("wiring broke")):
            prober = _prober(pkg, sched, tmp_path)

            def raise_(spec, _e=exc):
                raise _e

            monkeypatch.setattr(sched, "submit_info", raise_)
            result = prober.probe_once()
            doc = prober.status()
            seen.append((result, doc["ok"], doc["fail"], doc["last_error"]))
    finally:
        sched.shutdown()
    sched = _sched(pkg, paused=True)
    try:
        prober = _prober(pkg, sched, tmp_path / "slow", latency_s=1.0)
        seen.append((prober.probe_once(), prober.status()["last_error"]))
    finally:
        sched.shutdown()
    return seen


def test_skips_and_failures_equal_jax(tmp_path, monkeypatch):
    got = _failure_modes("port", tmp_path / "port", monkeypatch)
    assert got == _failure_modes("jax", tmp_path / "jax", monkeypatch)
    assert got[0] == (None, True, 0, "skipped: queue full")
    assert got[1][:3] == (False, False, 1) and "wiring broke" in got[1][3]
    assert got[2][0] is False and "latency bound" in got[2][1]


def test_maybe_start_and_quota_exemption_equal_jax(tmp_path, monkeypatch):
    for pkg in ("port", "jax"):
        mod, sched_mod = CANARY[pkg]
        sched = _sched(pkg, tenant_queue_cap=1, tenant_inflight_cap=1)
        try:
            monkeypatch.delenv("CCT_CANARY", raising=False)
            assert mod.maybe_start(sched, str(tmp_path / pkg)) is None
            monkeypatch.setenv("CCT_CANARY", "1")
            monkeypatch.setenv("CCT_CANARY_INTERVAL_S", "3600")
            prober = mod.maybe_start(sched, str(tmp_path / pkg))
            try:
                assert prober.is_alive() and sched.canary_info == prober.status
                assert sched.metrics()["canary"]["ok"] is True
            finally:
                prober.stop()
            spec = {"input": "/in/a.bam", "output": "/o/a", "name": "a", "tenant": "acme"}
            sched.pause()
            sched.submit(dict(spec))
            with pytest.raises(sched_mod.AdmissionRefused):
                sched.submit(dict(spec, name="b", output="/o/b"))
            for i in range(3):
                sched.submit({"input": "/in/c.bam", "output": f"/o/c{i}", "name": f"c{i}",
                              "tenant": sched_mod.CANARY_TENANT, "qos": "scavenger"})
        finally:
            sched.shutdown()


def test_obs_config_folds_the_canary_keys(tmp_path, monkeypatch):
    for var in ("CCT_CANARY", "CCT_CANARY_INTERVAL_S", "CCT_CANARY_LATENCY_S",
                "CCT_CANARY_GOLDEN", "CCT_CANARY_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("CCT_CANARY_LATENCY_S", "7")  # a set variable wins
    cfg = tmp_path / "c.ini"
    cfg.write_text("[obs]\ncanary = 1\ncanary_interval_s = 5\ncanary_latency_s = 60\n"
                   "canary_golden = ab\ncanary_dir = /d\n")
    torch_cli._apply_obs_config(str(cfg))
    assert {v: os.environ[v] for v in ("CCT_CANARY", "CCT_CANARY_INTERVAL_S",
                                       "CCT_CANARY_LATENCY_S", "CCT_CANARY_GOLDEN",
                                       "CCT_CANARY_DIR")} == \
        {"CCT_CANARY": "1", "CCT_CANARY_INTERVAL_S": "5", "CCT_CANARY_LATENCY_S": "7",
         "CCT_CANARY_GOLDEN": "ab", "CCT_CANARY_DIR": "/d"}
