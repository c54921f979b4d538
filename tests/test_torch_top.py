"""The port's ``obs/top.py`` and ``top`` command against the JAX package's (CPU).

- **Pure parts.** ``parse_prometheus``, ``qos_latency`` and
  ``render_frame(..., now=0.0)`` (paused, with and without the prof
  panel) of both packages are equal on the expositions of
  ``tests/test_obs.py`` (the crit row), ``tests/test_fleet_trace.py`` (the
  fleet layout) and ``tests/test_qc.py`` (the qc panel).
- **The names.** Every metric family the port's ``top`` reads is one the
  port's ``obs/registry.py`` registers (or its renderers write), under the
  reference's very name.
- **A real daemon.** A port ``serve --device cpu`` daemon's own
  ``metrics_prometheus()`` text after a job parses and renders alike
  through both packages; ``top --once`` against it exits 0 and prints the
  JAX ``render_frame`` of the very scrape it read.
"""

import glob
import os
import re
import subprocess
import sys
import time

import pytest

from consensuscruncher_tpu.obs import prof as jax_prof
from consensuscruncher_tpu.obs import top as jax_top
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.obs import prof as torch_prof
from consensuscruncher_tpu_torch.obs import registry
from consensuscruncher_tpu_torch.obs import top as torch_top
from consensuscruncher_tpu_torch.serve import client as torch_client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")

# tests/test_fleet_trace.py's fleet exposition
FLEET = """\
# HELP cct_router_epoch current ring-view epoch
cct_router_epoch 3
cct_router_active 1
cct_fleet_members 2
cct_fleet_members_up 2
cct_fleet_member_up{node="w0"} 1
cct_fleet_member_up{node="w1"} 0
cct_fleet_queue_depth{node="w0"} 4
cct_node_jobs_routed_total{node="w0"} 7
cct_node_steals_total{node="w0"} 2
cct_trace_spans_emitted_total{node="w0"} 42
cct_trace_orphans_total{node="w0"} 0
cct_tenant_job_wall_s_bucket{tenant="a",qos="batch",le="0.5"} 3
cct_tenant_job_wall_s_bucket{tenant="a",qos="batch",le="1"} 9
cct_tenant_job_wall_s_bucket{tenant="a",qos="batch",le="+Inf"} 10
cct_slo_burn_rate{node="w0",qos="batch",window="5m"} 1.25
cct_slo_burn_rate{node="w1",qos="batch",window="5m"} 0.5
malformed{ 12
"""
# tests/test_obs.py's crit-row exposition
CRIT = """\
cct_jobs_done_total 4
cct_lock_wait_us_total{lock="sched.cond"} 1500
cct_lock_wait_us_total{lock="job.id_lock"} 40
cct_dispatcher_idle_us_total 900000
cct_dispatcher_busy_us_total 100000
cct_canary_ok 1
cct_canary_age_s 3
"""
# tests/test_qc.py's partial qc exposition
QC = """\
cct_fleet_members 1
cct_fleet_members_up 1
cct_fleet_member_up{node="w0"} 1
cct_tenant_qc_families_total{tenant="a",qos="batch"} 12
cct_tenant_qc_sscs_written_total{tenant="a",qos="batch"} 9
cct_qc_docs_committed_total 2
cct_tenant_qc_disagreement_sum{tenant="a",qos="batch"} 0.02
cct_tenant_qc_disagreement_count{tenant="a",qos="batch"} 4
"""
EXPOSITIONS = {
    "fleet": FLEET,
    "crit": CRIT,
    "crit_failing_canary": CRIT.replace("cct_canary_ok 1", "cct_canary_ok 0"),
    "qc": QC,
    "net": FLEET + "cct_wire_crc_errors_total 3\ncct_conns_reaped_total 0\n",
    "cache_and_policy": QC + "cct_cache_hits_total 3\ncct_cache_misses_total 1\n"
    'cct_tenant_qc_policy_jobs_total{policy="delegation"} 2\n',
    "empty": "",
}
PROF_PANEL = {"w0": {"samples": 120, "queue_share": 0.25, "hot": "serve.gang:vote",
                     "hot_share": 0.4},
              "w1": {}}


def _pure(mod, text):
    series = mod.parse_prometheus(text)
    return {"series": series, "qos": mod.qos_latency(series),
            "frame": mod.render_frame(series, "unix:/tmp/x.sock", now=0.0),
            "paused": mod.render_frame(series, "x", paused=True, now=0.0),
            "prof": mod.render_frame(series, "x", now=0.0, prof=PROF_PANEL),
            "prof_empty": mod.render_frame(series, "x", now=0.0, prof={})}


@pytest.mark.parametrize("case", sorted(EXPOSITIONS))
def test_parse_qos_and_frame_equal_jax(case):
    assert _pure(torch_top, EXPOSITIONS[case]) == _pure(jax_top, EXPOSITIONS[case])


def test_every_metric_top_reads_is_registered_under_its_reference_name():
    port_src = open(torch_top.__file__).read()
    names = set(re.findall(r"\"(cct_[a-z0-9_]+)\"", port_src))
    assert names == set(re.findall(r"\"(cct_[a-z0-9_]+)\"", open(jax_top.__file__).read()))
    known = (set(registry.COUNTERS) | set(registry.LABELED_COUNTERS)
             | set(registry.LABELED_HISTOGRAMS) | set(registry.GAUGES)
             | set(registry.HISTOGRAMS))
    pkg = os.path.dirname(os.path.dirname(torch_top.__file__))
    writers = "".join(open(f).read() for f in glob.glob(os.path.join(pkg, "**", "*.py"),
                                                         recursive=True)
                      if not f.endswith(os.path.join("obs", "top.py")))
    for name in sorted(names):
        base = re.sub(r"_(total|bucket|sum|count)$", "", name[len("cct_"):])
        assert base in known or name in writers, name


# ------------------------------------------------------------ a real daemon

@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """A port ``serve --device cpu`` daemon (tracing on) that served one
    ``sample.bam`` job; yields its socket and stops it at the end."""
    tmp = tmp_path_factory.mktemp("top_daemon")
    sock = str(tmp / "d.sock")
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith(("CCT_TRACE", "CCT_PROF", "CCT_HISTORY"))}
    env.update(CCT_TRACE="1", CCT_TRACE_DIR=str(tmp / "traces"))
    log = open(tmp / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "serve", "--socket", sock,
         "--device", "cpu", "--node", "w0"],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(sock):
            assert proc.poll() is None and time.monotonic() < deadline, \
                open(tmp / "serve.log").read()
            time.sleep(0.05)
        client = torch_client.ServeClient(sock)
        sub = client.submit_full({"input": SAMPLE, "output": str(tmp / "out"), "name": "g",
                                  "tenant": "t1", "qos": "batch"})
        assert client.result(key=sub["key"], timeout=300)["state"] == "done"
        yield sock
        proc.terminate()
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def test_daemon_exposition_parses_and_renders_alike(daemon):
    text = torch_client.ServeClient(daemon).metrics_prometheus()
    port, jax = _pure(torch_top, text), _pure(jax_top, text)
    assert port == jax
    assert port["qos"]["batch"]["count"] == 1.0
    assert any(ln.startswith("qc:") for ln in port["frame"].splitlines())


class _FrozenTime:
    """``top.py``'s ``time`` module with the clock held at ``NOW``."""

    NOW = 1_000_000.0

    def __getattr__(self, name):
        return getattr(time, name)

    def time(self):
        return self.NOW


def test_top_once_prints_the_jax_frame_of_its_scrape(daemon, monkeypatch, capsys):
    replies = []
    request = torch_client.ServeClient.request

    def spy(self, req, *a, **k):
        reply = request(self, req, *a, **k)
        replies.append((req, reply))
        return reply

    monkeypatch.setattr(torch_client.ServeClient, "request", spy)
    monkeypatch.setattr(torch_top, "time", _FrozenTime())
    with pytest.raises(SystemExit) as exc:
        torch_cli.main(["top", "--once", "True", "--socket", daemon])
    assert exc.value.code == 0
    frame = capsys.readouterr().out
    ((req, reply),) = [(q, r) for q, r in replies if q.get("op") == "metrics"]
    assert req["format"] == "prometheus"
    want = jax_top.render_frame(jax_top.parse_prometheus(reply["prometheus"]),
                                f"unix:{daemon}", now=_FrozenTime.NOW)
    assert frame == want
    assert "cct top — unix:" in frame


def test_prof_panel_scrape_reduces_alike():
    docs = [{"lines": [
        {"pid": 7, "seq": 1, "node": "w0",
         "samples": {"serve.gang;a.f;b.g": 5, "serve.queue;c.h": 2},
         "attr": {"queue_ms": 250.0, "job_wall_ms": 1000.0, "jobs": 2}},
        {"pid": 8, "seq": 1, "samples": {"route.forward;d.i": 3}}]}]
    panel = torch_prof.top_panel(torch_prof.merge_profiles(docs))
    assert panel == jax_prof.top_panel(jax_prof.merge_profiles(docs))
    assert sorted(panel) == ["pid8", "w0"] and panel["w0"]["queue_share"] > 0
    assert torch_top.render_frame({}, "x", now=0.0, prof=panel) == \
        jax_top.render_frame({}, "x", now=0.0, prof=panel)
