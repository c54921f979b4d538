"""The port's copies of the obs core and the serve plumbing against the JAX
package's modules (CPU), each case fed the same inputs through both.

- ``serve/wire``: sealed frames (seq + crc envelope) byte-equal, verify
  and the replay cache agree, also on corrupted frames;
- ``obs/metrics.render_prometheus`` (and the fleet renderer) on one
  metrics document, and the labeled-series validation;
- ``obs/slo.SloMonitor``: quantiles, shed ratios and burn rates on a fake
  clock;
- ``obs/flight``: the dump document of one event sequence (times and pid
  aside);
- ``obs/history``: the shard lines of one snapshot sequence (times and
  pid aside), the torn-line read, the merge, query and trend;
- ``utils/faults``: the ``CCT_FAULTS`` spec parse and the firing
  sequence, per process and across processes through a ledger dir;
- ``utils/sanitize``: the lock-order inversion error;
- ``obs/trace``: the Chrome-trace export of one event list (flow arrows
  included), and the span/event records of one sequence (ids and times
  aside);
- ``parallel/batching``: ``interleave_sources`` and the batches
  ``bucket_families`` packs from it;
- ``serve/warmup.parse_shapes``.
"""

import json
import os

import numpy as np
import pytest

from consensuscruncher_tpu.obs import flight as jax_flight
from consensuscruncher_tpu.obs import history as jax_history
from consensuscruncher_tpu.obs import metrics as jax_metrics
from consensuscruncher_tpu.obs import slo as jax_slo
from consensuscruncher_tpu.obs import trace as jax_trace
from consensuscruncher_tpu.parallel import batching as jax_batching
from consensuscruncher_tpu.serve import warmup as jax_warmup
from consensuscruncher_tpu.serve import wire as jax_wire
from consensuscruncher_tpu.utils import faults as jax_faults
from consensuscruncher_tpu.utils import sanitize as jax_sanitize
from consensuscruncher_tpu_torch.obs import flight as torch_flight
from consensuscruncher_tpu_torch.obs import history as torch_history
from consensuscruncher_tpu_torch.obs import metrics as torch_metrics
from consensuscruncher_tpu_torch.obs import registry as torch_registry
from consensuscruncher_tpu_torch.obs import slo as torch_slo
from consensuscruncher_tpu_torch.obs import trace as torch_trace
from consensuscruncher_tpu_torch.parallel import batching as torch_batching
from consensuscruncher_tpu_torch.serve import warmup as torch_warmup
from consensuscruncher_tpu_torch.serve import wire as torch_wire
from consensuscruncher_tpu_torch.utils import faults as torch_faults
from consensuscruncher_tpu_torch.utils import sanitize as torch_sanitize

DOCS = [
    {"op": "submit", "spec": {"input": "/x/a.bam", "output": "/o", "qos": "batch"}},
    {"op": "result", "key": "k" * 32, "timeout": 1.5},
    {"ok": True, "job": {"job_id": 7, "state": "done", "wall_s": 0.25, "qc": None}},
    {"z": [1, 2, {"b": "é", "a": None}], "a": -3},
]


@pytest.mark.parametrize("doc", DOCS)
def test_wire_frames_equal_jax(doc):
    for seq in (0, 1, 2 ** 31):
        port, ref = torch_wire.seal(doc, seq), jax_wire.seal(doc, seq)
        assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
        assert torch_wire.crc_of(port) == jax_wire.crc_of(ref)
        assert torch_wire.verify(port) and jax_wire.verify(port)
        bad = dict(port, seq=seq + 1)
        assert torch_wire.verify(bad) == jax_wire.verify(bad) is False
    # exotic keys degrade to seq-only in both
    odd = {1: "x", "a": 2}
    assert torch_wire.seal(odd, 3) == jax_wire.seal(odd, 3)


def test_wire_replay_cache_equals_jax():
    port, ref = torch_wire.ReplayCache(max_entries=3), jax_wire.ReplayCache(max_entries=3)
    trace = []
    for seq in [1, 2, 1, 3, "4", 5, None, 2, 1, 5]:
        got = (port.check(seq), ref.check(seq))
        trace.append(got)
        assert got[0] == got[1]
        port.remember(seq, {"seq": seq})
        ref.remember(seq, {"seq": seq})
    assert any(p is not None for p, _ in trace)


def _metrics_doc():
    return {
        "stage": "serve", "phases_s": {"uptime": 12.5}, "n_jobs": 3, "queue_bound": 16,
        "gang_size": 4, "draining": False,
        "jobs_by_state": {"done": 2, "failed": 1, "queued": 0},
        "cumulative": {k: i for i, k in enumerate(torch_registry.CUMULATIVE_KEYS)},
        "journal": {"path": "/j", "size_bytes": 4096},
        "canary": {"ok": True, "age_s": 3.25},
        "histograms": {
            "queue_wait_s": {"buckets": [0.1, 1.0], "counts": [1, 2, 3], "sum": 9.5,
                             "count": 6},
            "batch_occupancy": {"buckets": [0.5, 1.0], "counts": [0, 4, 0], "sum": 3.0,
                                "count": 4}},
        "labeled": {
            "counters": {"tenant_jobs_done": [
                {"labels": {"tenant": 'a"b\\c\nd', "qos": "batch"}, "value": 2}]},
            "histograms": {"tenant_job_wall_s": [
                {"labels": {"tenant": "t", "qos": "interactive"}, "buckets": [1.0, 2.0],
                 "counts": [1, 1, 0], "sum": 2.5, "count": 2}]}},
        "slo": {"classes": {
            "interactive": {"target_s": 30.0, "p50_s": 0.5, "p99_s": 2.0,
                            "shed_ratio": 0.25, "burn_rate": {"60s": 1.5, "3600s": None}},
            "batch": {"target_s": None, "p50_s": None, "p99_s": None, "shed_ratio": 0.0,
                      "burn_rate": {}}}},
    }


#: help texts the port rewords (what the port counts, not what JAX does),
#: and the port's own counters, which the JAX registry has no help text for
REWORDED = ("cct_recompiles_total", "cct_bytes_h2d_total", "cct_bytes_d2h_total",
            "cct_device_dispatch_s", "cct_deflate_wall_us_total",
            "cct_vote_member_positions_total", "cct_vote_output_positions_total")


def _mask_reworded(text):
    return [ln.split(" ")[:3] if ln.startswith("# HELP ") and ln.split(" ")[2] in REWORDED
            else ln for ln in text.splitlines()]


def test_render_prometheus_equals_jax():
    doc = _metrics_doc()
    doc["histograms"]["device_dispatch_s"] = dict(doc["histograms"]["queue_wait_s"])
    port = torch_metrics.render_prometheus(doc)
    ref = jax_metrics.render_prometheus(doc)
    assert _mask_reworded(port) == _mask_reworded(ref)
    assert sum(a != b for a, b in zip(port.splitlines(), ref.splitlines())) == len(REWORDED)
    assert "cct_families_in_total 0" in port and 'cct_jobs{state="done"} 2' in port
    fleet = {"cumulative": doc["cumulative"], "epoch": 3, "ha_state": "active",
             "fleet": {"size": 2, "up": 1, "members": [
                 {"name": "w1", "up": True, "queued": 2, "running": 1},
                 {"name": "w0", "up": False, "queued": 0, "running": 0, "draining": True}]},
             "nodes": {"w1": doc, "w0": None}}
    assert _mask_reworded(torch_metrics.render_fleet_prometheus(fleet)) == \
        _mask_reworded(jax_metrics.render_fleet_prometheus(fleet))


def test_labeled_series_validate_as_jax():
    for mod in (torch_metrics, jax_metrics):
        with pytest.raises(KeyError):
            mod.inc("tenant_jobs_done", tenant="t")
        with pytest.raises(ValueError):
            mod.inc("tenant_jobs_done", tenant="t", qos="gold")
        with pytest.raises(KeyError):
            mod.observe("no_such_histogram", 1.0)
    assert torch_registry.QOS_CLASSES == ("interactive", "batch", "scavenger")
    h_port, h_ref = torch_metrics.Histogram([0.1, 1.0, 10.0]), jax_metrics.Histogram(
        [0.1, 1.0, 10.0])
    for v in (0.05, 0.1, 0.5, 3.0, 11.0, 1.0):
        h_port.observe(v)
        h_ref.observe(v)
    assert h_port.snapshot() == h_ref.snapshot()


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _slo_trace(mod):
    clock = _Clock()
    mon = mod.SloMonitor(targets={"interactive": 1.0, "batch": 10.0}, objective=0.9,
                         windows=(60.0, 600.0), clock=clock)
    rng = np.random.default_rng(3)
    out = []
    for i in range(120):
        clock.t += float(rng.uniform(0.5, 20.0))
        qos = ("interactive", "batch", "scavenger")[i % 3]
        if i % 11 == 0:
            mon.note(qos, shed=True)
        else:
            mon.note(qos, wall_s=float(rng.lognormal(0.0, 1.2)))
        if i % 20 == 19:
            out.append((mon.snapshot(), mon.health()))
    return out


def test_slo_monitor_equals_jax():
    port, ref = _slo_trace(torch_slo), _slo_trace(jax_slo)
    assert port == ref
    assert any(c["burn_rate"]["60s"] > 0 for snap, _ in port for c in snap["classes"].values())
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        args = ([0.1, 1.0, 5.0], [3, 0, 7, 2], q)
        assert torch_slo.quantile_from_histogram(*args) == jax_slo.quantile_from_histogram(*args)


def _without(doc, keys):
    return {k: v for k, v in doc.items() if k not in keys}


def test_flight_dump_equals_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("CCT_TRACE", raising=False)
    docs = []
    for name, mod in (("port", torch_flight), ("ref", jax_flight)):
        rec = mod.FlightRecorder(capacity=4)
        rec.set_identity(node="w0", epoch=2)
        for i in range(6):
            rec.record("shed" if i % 2 else "retry", job_id=i, why=f"w{i}")
        path = rec.dump(str(tmp_path / f"{name}.json"), reason="test")
        with open(path) as fh:
            doc = json.load(fh)
        doc["events"] = [_without(e, ("t",)) for e in doc["events"]]
        docs.append(_without(doc, ("pid", "dumped_at", "prof")))
        assert rec.dump() is None  # no dump dir: nothing written
    assert docs[0] == docs[1]
    assert [e["job_id"] for e in docs[0]["events"]] == [2, 3, 4, 5]


def test_history_shards_equal_jax(tmp_path, monkeypatch):
    cums = [{"families_in": 5, "jobs_shed": 0}, {"families_in": 5, "jobs_shed": 0},
            {"families_in": 9, "jobs_shed": 1, "ratio": 0.5}, {"families_in": 12.25}]
    shards = []
    for name, mod in (("port", torch_history), ("ref", jax_history)):
        d = tmp_path / name
        monkeypatch.setenv("CCT_HISTORY_DIR", str(d))
        # one clock for both packages: the lines' "t" and "dt_s" (and so
        # the bytes written) must not depend on when each module ran
        ticks = iter(range(100))
        monkeypatch.setattr(mod, "time", type("Clock", (), {
            "time": staticmethod(lambda: 1.0e9), "monotonic": staticmethod(
                lambda: 2.5 * next(ticks))}))
        mod.reset_for_tests()
        wrote = [mod.append_snapshot(c, {"queued": i}) for i, c in enumerate(cums)]
        (shard,) = os.listdir(d)
        lines = mod.read_shard(str(d / shard))
        shards.append((wrote, [_without(ln, ("t", "dt_s", "pid")) for ln in lines],
                       mod.counter_snapshot()))
        mod.reset_for_tests()
    assert shards[0] == shards[1]
    assert shards[0][0][1] == 0  # a flat interval writes nothing
    # torn lines, merge, query, trend and the table over the same bytes
    blob = tmp_path / "torn.ndjson"
    good = [{"v": 1, "pid": p, "seq": s, "t": 10.0 * s + p, "dt_s": 2.0, "node": n,
             "cum": {"jobs_shed": s}, "gauges": {"queued": p}}
            for p, s, n in ((1, 1, "a"), (2, 1, "b"), (1, 2, "a"), (1, 2, "a"))]
    blob.write_text("".join(json.dumps(ln) + "\n" for ln in good) + '{"v": 1, "pid"\n\n[1]\n')
    for mod in (torch_history, jax_history):
        assert mod.read_shard(str(blob)) == good
    merged = [torch_history.merge_history([{"lines": good}, {"lines": good[:2]}]),
              jax_history.merge_history([{"lines": good}, {"lines": good[:2]}])]
    assert merged[0] == merged[1] and len(merged[0]) == 3
    for metric in ("jobs_shed", "queued", "absent"):
        rows = torch_history.trend(merged[0], metric)
        assert rows == jax_history.trend(merged[0], metric)
        assert torch_history.render_trend(rows, metric) == jax_history.render_trend(rows, metric)
        assert torch_history.query(merged[0], metric, node="a", last=1) == \
            jax_history.query(merged[0], metric, node="a", last=1)


SPECS = ["serve.worker=exit@2:3,serve.dispatch=fail,serve.shed=stall:0.0",
         " bad , serve.oom=kill:SIGUSR1 ,x=fail@0", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_and_firing_equal_jax(spec, tmp_path):
    sites = ("serve.worker", "serve.dispatch", "serve.shed", "serve.oom", "x", "absent")
    seqs = []
    for mod, ledger in ((torch_faults, None), (jax_faults, None),
                        (torch_faults, str(tmp_path / "p")), (jax_faults, str(tmp_path / "j"))):
        inj = mod.FaultInjector(spec, ledger)
        seqs.append((inj._sites, [(s, inj.armed(s), inj.fire(s)) for _ in range(3)
                                  for s in sites]))
    assert seqs[0] == seqs[1] == seqs[2] == seqs[3]
    assert torch_faults.backoff_delay(4, 0.5, 30.0) == jax_faults.backoff_delay(4, 0.5, 30.0)


def test_fault_point_and_retrying_equal_jax(monkeypatch):
    monkeypatch.setenv("CCT_FAULTS", "serve.dispatch=fail@2")
    monkeypatch.delenv("CCT_FAULTS_DIR", raising=False)
    out = []
    for mod in (torch_faults, jax_faults):
        calls = []
        res = mod.retrying(lambda: calls.append(1) or "done", site="serve.dispatch",
                           attempts=3, base_delay=0.0, sleep=lambda s: None)
        hook = mod.hook("serve.dispatch")
        raised = []
        for site in ("serve.dispatch", "serve.worker"):
            try:
                mod.fault_point(site)
            except mod.FaultError as e:
                raised.append(str(e))
        out.append((res, len(calls), hook is not None, raised, mod.hook("serve.worker")))
        monkeypatch.setenv("CCT_FAULTS", "serve.dispatch=fail@2 ")  # re-parse: fresh budget
        monkeypatch.setenv("CCT_FAULTS", "serve.dispatch=fail@2")
    assert out[0] == out[1]


def test_lock_order_error_equals_jax(monkeypatch):
    monkeypatch.setenv("CCT_SANITIZE", "1")
    errors = []
    for mod in (torch_sanitize, jax_sanitize):
        mod.reset_lock_tracking()
        a, b = mod.tracked_lock("scheduler.cond"), mod.tracked_lock("journal.lock")
        with a, b:
            pass
        with b:
            with pytest.raises(mod.LockOrderError) as exc:
                a.acquire()
        errors.append(str(exc.value))
        cond = mod.tracked_condition("job.id_lock")
        with cond:
            with a:
                pass
        with a:
            with pytest.raises(mod.LockOrderError):
                cond.acquire()
        mod.reset_lock_tracking()
    assert errors[0] == errors[1]
    assert "lock order inversion" in errors[0]


EVENTS = [
    {"name": "serve.submit", "cat": "cct", "ph": "X", "ts": 100, "dur": 5, "pid": 7, "tid": 1,
     "args": {"trace_id": "t1", "span": 1, "hop": 0}},
    {"name": "route.forward", "cat": "cct", "ph": "X", "ts": 104, "dur": 9, "pid": 8, "tid": 2,
     "args": {"trace_id": "t1", "span": 4, "hop": 1,
              "follows_from": {"pid": 7, "span": 1, "hop": 0}}},
    {"name": "device.batch", "cat": "cct", "ph": "i", "s": "t", "ts": 106, "pid": 8, "tid": 2,
     "args": {"trace_ids": ["t1", "t2"], "n_real": 12, "parent": 4}},
    {"name": "orphan", "cat": "cct", "ph": "X", "ts": 120, "dur": 1, "pid": 9, "tid": 3,
     "args": {"follows_from": {"pid": 99, "span": 3}}},
]


def test_chrome_trace_export_equals_jax(tmp_path):
    for name, groups in (("one", [EVENTS]), ("two", [EVENTS[:2], EVENTS[1:]])):
        port, ref = tmp_path / f"{name}.port.json", tmp_path / f"{name}.ref.json"
        assert torch_trace.merge_fleet_trace(groups, str(port)) == \
            jax_trace.merge_fleet_trace(groups, str(ref))
        assert port.read_bytes() == ref.read_bytes()
    shard_dir = tmp_path / "shards"
    shard_dir.mkdir()
    (shard_dir / "trace-7.ndjson").write_text(
        "".join(json.dumps(e) + "\n" for e in EVENTS) + '{"torn": \n')
    assert torch_trace.export_chrome_trace(str(shard_dir), str(tmp_path / "p.json")) == \
        jax_trace.export_chrome_trace(str(shard_dir), str(tmp_path / "r.json"))
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "r.json").read_bytes()


def _span_records(mod):
    mod.drain_events()
    with mod.span("serve.gang", trace_id="tX", n_jobs=2):
        mod.event("device.batch", n_real=3, trace_ids=["a", "b"])
        with mod.span("writer.commit"):
            ctx = mod.wire_context()
    with mod.span("serve.replay", link=ctx, key="k"):
        pass
    out = []
    for ev in mod.drain_events():
        args = {k: v for k, v in ev["args"].items()
                if k not in ("span", "parent", "trace_id")}
        if "follows_from" in args:
            args["follows_from"] = {k: v for k, v in args["follows_from"].items()
                                    if k not in ("span", "pid")}
        out.append((ev["name"], ev["ph"], args, ev["args"].get("trace_id") == "tX"))
    return out, mod.counter_snapshot()


def test_span_records_equal_jax(monkeypatch):
    monkeypatch.setenv("CCT_TRACE", "1")
    monkeypatch.delenv("CCT_TRACE_DIR", raising=False)
    port, ref = _span_records(torch_trace), _span_records(jax_trace)
    assert port[0] == ref[0]
    assert [r[0] for r in port[0]] == ["device.batch", "writer.commit", "serve.gang",
                                       "serve.replay"]
    assert all(r[3] for r in port[0])  # the link carries the trace id across the hop


def test_interleave_and_bucket_shapes_equal_jax():
    sources = [[("a", i) for i in range(5)], [], [("b", i) for i in range(2)],
               [("c", i) for i in range(4)]]
    port = list(torch_batching.interleave_sources(sources))
    assert port == list(jax_batching.interleave_sources(sources))
    assert port[:4] == [("a", 0), ("b", 0), ("c", 0), ("a", 1)]
    rng = np.random.default_rng(11)
    fams = []
    for i in range(300):
        f = int(rng.integers(1, 9))
        length = int(rng.choice([60, 100, 140]))
        fams.append((i, [rng.integers(0, 4, length, dtype=np.uint8) for _ in range(f)],
                     [rng.integers(0, 41, length, dtype=np.uint8) for _ in range(f)]))
    batches = []
    for mod in (torch_batching, jax_batching):
        batches.append([(b.keys, b.bases.tobytes(), b.quals.tobytes(), b.bases.shape)
                        for b in mod.bucket_families(
                            mod.interleave_sources([fams[:150], fams[150:]]), max_batch=16)])
    assert batches[0] == batches[1] and batches[0]


def test_warmup_shapes_and_ladder_equal_jax(tmp_path):
    text = " 8x4x96, 16X8x160,,64x1x32 "
    assert torch_warmup.parse_shapes(text) == jax_warmup.parse_shapes(text)
    for bad in ("8x4", "0x4x96", "ax4x96"):
        with pytest.raises(ValueError):
            torch_warmup.parse_shapes(bad)
        with pytest.raises(ValueError):
            jax_warmup.parse_shapes(bad)
    # no shapes: serve warms once at the library shape, a valid bucket
    assert torch_warmup.parse_shapes("") == jax_warmup.parse_shapes("") == []
    assert torch_warmup.parse_shapes("x".join(map(str, torch_warmup.LIBRARY_WARM_SHAPE))) == \
        [torch_warmup.LIBRARY_WARM_SHAPE]
