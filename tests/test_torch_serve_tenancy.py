"""Admission, shedding, quotas and stride order of the port's scheduler
against the JAX package's (CPU, paused schedulers, no dispatch thread).

The same scripted submits go to both packages' ``Scheduler``s: every
admission outcome (admitted, or the refusal's class and message), the
stride-scheduled pop order, the quarantine and circuit-breaker path, the
brownout, the per-tenant labeled counters and the healthz/metrics blocks
are equal.  Job ids are process counters, so the script records names.
"""

import pytest

from consensuscruncher_tpu.obs import metrics as jax_metrics
from consensuscruncher_tpu.serve import scheduler as jax_sched
from consensuscruncher_tpu_torch.obs import metrics as torch_metrics
from consensuscruncher_tpu_torch.serve import scheduler as torch_sched

BOTH = (("port", torch_sched, torch_metrics, {"device": "cpu"}),
        ("jax", jax_sched, jax_metrics, {"backend": "tpu"}))


@pytest.fixture(autouse=True)
def _clean_metrics():
    for mod in (torch_metrics, jax_metrics):
        mod.reset_for_tests()
    yield
    for mod in (torch_metrics, jax_metrics):
        mod.reset_for_tests()


def _spec(i, tenant="default", qos=None, **kw):
    spec = {"input": f"/in/{i}.bam", "output": f"/out/{i}", "name": f"j{i}", "tenant": tenant}
    if qos is not None:
        spec["qos"] = qos
    spec.update(kw)
    return spec


def _outcome(sched, spec):
    try:
        job, created = sched.submit_info(spec)
    except Exception as e:  # the refusal is the outcome
        return (type(e).__name__, str(e))
    return ("admitted", job.spec["name"], job.tenant, job.qos, created)


def _pops(sched):
    order = []
    with sched._cond:
        while sched._any_queued_locked():
            order.append([j.spec["name"] for j in sched._pop_gang_locked()])
    return order


def _labeled(mod):
    return mod.labeled_snapshot()["counters"]


def _admission_script(sched_mod, metrics_mod, kw):
    sched = sched_mod.Scheduler(queue_bound=9, gang_size=2, paused=True, start=False,
                                class_weights={"interactive": 3.0, "batch": 2.0},
                                slo_targets={"batch": 5.0}, tenant_queue_cap=3,
                                tenant_inflight_cap=4, **kw)
    out = []
    submits = [
        _spec(0), _spec(1, qos="batch"), _spec(2, qos="scavenger", tenant="acme"),
        _spec(3, qos="warp"), _spec(0), _spec(4, tenant="acme", qos="batch"),
        _spec(5, tenant="acme"), _spec(6, tenant="acme"), _spec(7, policy="majority"),
        _spec(8, policy="nope"), _spec(9, qos="batch", cutoff=0.6), _spec(10, qos="batch"),
        _spec(11, qos="interactive", policy="delegation"), _spec(12), _spec(13),
    ]
    for spec in submits:
        out.append(_outcome(sched, spec))
    # the observed service rate makes deadlines bite: explicit and class-SLO
    sched._ewma_job_s = 4.0
    out += [_outcome(sched, _spec(20, deadline_s=1.0, tenant="z")),
            _outcome(sched, _spec(21, qos="batch", tenant="z")),
            _outcome(sched, _spec(22, deadline_s=1000.0, tenant="z"))]
    out.append(("pops", _pops(sched)))
    out.append(("labeled", _labeled(metrics_mod)))
    snap = sched.counters.snapshot()
    out.append(("counters", {k: snap[k] for k in ("jobs_shed", "queue_depth_hwm")}))
    health = sched.healthz()
    out.append(("health", {k: health[k] for k in ("status", "queued", "queued_by_class",
                                                  "running", "quarantined")}))
    sched.stop_admission()
    out.append(_outcome(sched, _spec(30)))
    return out


def test_admission_and_stride_order_equal_jax():
    port, ref = (_admission_script(mod, met, kw) for _n, mod, met, kw in BOTH)
    assert port == ref
    kinds = [o[0] for o in port]
    assert {"ValueError", "QuotaRefused", "DeadlineShed", "AdmissionRefused"} <= set(kinds)
    pops = next(o[1] for o in port if o[0] == "pops")
    assert any(len(g) == 2 for g in pops)  # compatible jobs gang up


def _stride_script(sched_mod, kw):
    sched = sched_mod.Scheduler(queue_bound=64, gang_size=1, paused=True, start=False,
                                class_weights={"interactive": 2.0, "batch": 1.0,
                                               "scavenger": 1.0}, **kw)
    for i in range(6):
        sched.submit(_spec(100 + i, qos="batch"))
    with sched._cond:
        first = [sched._pop_gang_locked()[0].spec["name"] for _ in range(3)]
    for i in range(8):
        sched.submit(_spec(200 + i, qos="interactive"))
    for i in range(4):
        sched.submit(_spec(300 + i, qos="scavenger"))
    return first, _pops(sched)


def test_stride_order_with_a_late_class_equals_jax():
    port, ref = (_stride_script(mod, kw) for _n, mod, _m, kw in BOTH)
    assert port == ref
    order = [g[0] for g in port[1]]
    assert len(order) == 15 and order[:2] != ["j200", "j201"]  # no banked credit


def _containment_script(sched_mod, kw, monkeypatch):
    monkeypatch.setenv("CCT_SERVE_MAX_FLEET_ATTEMPTS", "1")
    monkeypatch.setenv("CCT_SERVE_BREAKER_QUARANTINES", "1")
    sched = sched_mod.Scheduler(queue_bound=8, gang_size=1, paused=True, start=False, **kw)
    out = []
    job = sched.submit(_spec(40, tenant="t"))
    with sched._cond:
        (popped,) = sched._pop_gang_locked()
        out.append(sched._predispatch_locked(popped))   # attempt 1 of 1: dispatch
        out.append(sched._predispatch_locked(popped))   # budget spent: quarantine
    out.append((job.state, job.error))
    out.append(_outcome(sched, _spec(40, tenant="t")))              # the key is parked
    out.append(_outcome(sched, _spec(40, tenant="t", output="/o2")))  # breaker: same input
    out.append(_outcome(sched, _spec(41, tenant="t")))               # another input: fine
    out.append(sched.release_quarantine(job.key))
    out.append(sched.release_quarantine("nope"))
    out.append((job.state, sched.quarantined_keys()))
    snap = sched.counters.snapshot()
    out.append({k: snap[k] for k in ("jobs_quarantined", "fleet_attempts_exhausted",
                                     "breaker_open", "quarantine_released")})
    monkeypatch.setenv("CCT_FAULTS", "serve.oom=fail@1,serve.shed=fail@1")
    out.append(_outcome(sched, _spec(50, qos="scavenger")))  # watermark: oom
    out.append(_outcome(sched, _spec(51)))                   # forced shed
    out.append(_outcome(sched, _spec(52)))
    monkeypatch.setenv("CCT_FAULTS", "serve.enospc=fail@1")
    out.append(_outcome(sched, _spec(53)))  # no journal: nothing to fill
    monkeypatch.delenv("CCT_FAULTS")
    return out


def test_quarantine_breaker_and_forced_sheds_equal_jax(monkeypatch):
    port = _containment_script(torch_sched, {"device": "cpu"}, monkeypatch)
    ref = _containment_script(jax_sched, {"backend": "tpu"}, monkeypatch)
    # the breaker's fault domain: tenant + input in both (the JAX package's
    # content digest of an input that does not exist is none)
    assert port == ref
    assert port[0] is False and port[1] is True
    assert port[3][0] == port[4][0] == "QuarantineRefused" and port[5][0] == "admitted"


def _brownout_script(sched_mod, kw, tmp_path, monkeypatch, name):
    sched = sched_mod.Scheduler(queue_bound=8, paused=True, start=False,
                                journal=str(tmp_path / f"{name}.wal"), **kw)
    out = [_outcome(sched, _spec(60))]
    monkeypatch.setenv("CCT_FAULTS", "serve.enospc=fail@1")
    out.append(_outcome(sched, _spec(61))[0])
    out.append(sched.healthz()["status"])
    monkeypatch.delenv("CCT_FAULTS")
    out.append(_outcome(sched, _spec(62)))
    out.append(sched.healthz()["status"])
    out.append(sched.counters.snapshot()["brownout_refusals"])
    sched.shutdown()
    return out


def test_brownout_equals_jax(tmp_path, monkeypatch):
    port = _brownout_script(torch_sched, {"device": "cpu"}, tmp_path, monkeypatch, "p")
    ref = _brownout_script(jax_sched, {"backend": "tpu"}, tmp_path, monkeypatch, "j")
    assert port == ref
    assert port[1] == "BrownoutRefused" and port[2] == "brownout" and port[4] == "serving"
