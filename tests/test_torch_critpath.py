"""The port's ``obs/critpath.py`` and ``critpath`` command against the JAX package's (CPU).

- **The math.** ``report_doc``, ``render_report``, ``render_job`` and
  ``to_json`` of both packages on the event lists ``tests/test_critpath.py``
  builds (every boundary, a shed tail, a refusal at the door, a run split
  by its ``serve.job`` span, exact duplicates, ten jobs with antagonists)
  are equal, text for text.
- **A real daemon.** A port ``serve --device cpu`` daemon with
  ``CCT_TRACE=1`` (and ``CCT_PROF=1``) serves three small jobs; its ``serve.critpath`` events
  (read over the ``trace`` wire op) go through both packages' critpath
  alike, and every job's segments sum to its wall.
- **The command.** ``critpath report|job`` through both CLIs on the
  daemon's ``--dir`` shards (the wire refused): the same stdout, the same
  ``--json`` bytes, and the same ``SystemExit`` text for an empty
  directory, an unknown key and a missing key.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from consensuscruncher_tpu import cli as jax_cli
from consensuscruncher_tpu.obs import critpath as jax_critpath
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.obs import critpath as torch_critpath
from consensuscruncher_tpu_torch.serve.client import ServeClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")
ALL_STAMPS = {"submit": 0.0, "admit": 1.0, "journal": 3.0, "ack": 4.0,
              "gang": 10.0, "dispatch": 11.0, "run": 12.0}


def _ev(stamps, wall_ms, state="done", job_id=7, pid=100, ts=1.0, antagonist=None,
        queue_wait_ms=0.0):
    return {"name": "serve.critpath", "ph": "i", "pid": pid, "ts": ts, "node": "n0",
            "args": {"job_id": job_id, "key": f"k{job_id}", "state": state,
                     "tenant": "default", "qos": "interactive", "gang_size": 1,
                     "cached": False, "wall_ms": wall_ms, "queue_wait_ms": queue_wait_ms,
                     "stamps": stamps, "antagonist": antagonist or {}}}


def _ten_jobs():
    events = []
    for i in range(10):
        stamps = {"submit": 0.0, "admit": 1.0, "journal": 2.0, "ack": 3.0,
                  "gang": 3.0 + i, "dispatch": 4.0 + i, "run": 5.0 + i}
        ant = ({"kind": "dispatcher", "busy_on_jobs": [1, 2, 3, 4, 5], "queue_ms": float(i),
                "dispatcher_busy_ms": 2.5 * i, "idle_ms": 0.0} if i < 8 else
               {"kind": "idle", "queue_ms": float(i)})
        events.append(_ev(stamps, wall_ms=10.0 + i, job_id=i, antagonist=ant))
    return events


# the event lists of tests/test_critpath.py, one list per case
EVENT_LISTS = {
    "telescoping": [_ev(ALL_STAMPS, wall_ms=20.0)],
    "shed_tail": [_ev({"submit": 0.0, "admit": 0.5, "journal": 1.0, "ack": 1.5},
                      wall_ms=50.0, state="failed", queue_wait_ms=48.5)],
    "refused_at_the_door": [_ev({"submit": 0.0}, wall_ms=2.0, state="failed")],
    "run_split": [_ev(ALL_STAMPS, wall_ms=20.0),
                  {"name": "serve.job", "ph": "X", "pid": 100,
                   "args": {"job_id": 7, "device_dispatch_ms": 5.0, "deflate_ms": 3.0,
                            "host_cpu_ms": 4.0}}],
    "run_split_clamped": [_ev(ALL_STAMPS, wall_ms=20.0),
                          {"name": "serve.job", "ph": "X", "pid": 100,
                           "args": {"job_id": 7, "device_dispatch_ms": 40.0}}],
    "duplicates": [_ev({"submit": 0.0, "admit": 1.0}, wall_ms=2.0)] * 2
    + [_ev({"submit": 0.0, "admit": 1.0}, wall_ms=2.0, pid=101),
       {"name": "serve.job", "ph": "X", "pid": 100, "args": {"job_id": 7}}],
    "ten_jobs": _ten_jobs(),
    "lock_antagonist": [_ev({**ALL_STAMPS, "gang": 9.0, "dispatch": 10.0, "run": 11.0},
                            wall_ms=15.0, antagonist={"kind": "lock", "lock": "sched",
                                                      "lock_holder": "dispatcher",
                                                      "queue_ms": 6.0})],
    "zero_wall": [_ev({"submit": 0.0, "admit": 0.0}, wall_ms=0.0)],
    "empty": [],
}


def _rendered(mod, events):
    doc = mod.report_doc(events)
    return {"doc": doc, "report": mod.render_report(doc), "json": mod.to_json(doc),
            "jobs": [mod.render_job(job) for job in doc["jobs"]],
            "fleet": mod.fleet_report(doc["jobs"]),
            "labels": [mod.antagonist_label(job["antagonist"]) for job in doc["jobs"]]}


@pytest.mark.parametrize("case", sorted(EVENT_LISTS))
def test_report_doc_and_renders_equal_jax(case):
    events = EVENT_LISTS[case]
    assert _rendered(torch_critpath, events) == _rendered(jax_critpath, events)


def test_antagonist_labels_equal_jax():
    for ant in ({"kind": "lock", "lock": "sched", "lock_holder": "dispatcher"},
                {"kind": "lock", "lock": "sched"}, {"kind": "lock"},
                {"kind": "dispatcher", "busy_on_jobs": [3, 4, 5, 6, 7]},
                {"kind": "dispatcher"}, {"kind": "idle"}, {}, None, {"kind": "other"}):
        assert torch_critpath.antagonist_label(ant) == jax_critpath.antagonist_label(ant)


# ------------------------------------------------------------ a real daemon

def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith(("CCT_TRACE", "CCT_PROF", "CCT_HISTORY"))}
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """A port ``serve --device cpu`` daemon with tracing and the profiler
    on (whose span deltas split a job's run segment) that served three
    small jobs of ``sample.bam``; stopped with
    SIGTERM, so its trace shard is flushed.  Yields its events (read over
    the wire before the stop), its trace directory and the submit
    replies."""
    tmp = tmp_path_factory.mktemp("critpath_daemon")
    sock, trace_dir = str(tmp / "d.sock"), str(tmp / "traces")
    log = open(tmp / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "serve", "--socket", sock,
         "--journal", str(tmp / "j.wal"), "--device", "cpu", "--gang_size", "4"],
        cwd=REPO, env=_clean_env(CCT_TRACE="1", CCT_TRACE_DIR=trace_dir, CCT_PROF="1",
                                 CCT_PROF_DIR=str(tmp / "prof")), stdout=log,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(sock):
            assert proc.poll() is None and time.monotonic() < deadline, \
                open(tmp / "serve.log").read()
            time.sleep(0.05)
        client = ServeClient(sock)
        subs = [client.submit_full({"input": SAMPLE, "output": str(tmp / "out"),
                                    "name": f"j{i}"}) for i in range(3)]
        for sub in subs:
            assert client.result(key=sub["key"], timeout=300)["state"] == "done"
        events = client.request({"op": "trace"})["trace"]["events"]
        proc.terminate()
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    yield {"events": events, "trace_dir": trace_dir, "subs": subs}


def test_daemon_events_decompose_alike(daemon):
    events = daemon["events"]
    port, jax = _rendered(torch_critpath, events), _rendered(jax_critpath, events)
    assert port == jax
    jobs = port["doc"]["jobs"]
    assert sorted(j["key"] for j in jobs) == sorted(s["key"] for s in daemon["subs"])
    for job in jobs:
        assert job["state"] == "done" and job["segments"][-1]["name"] == "run"
        assert all(seg["ms"] >= 0 for seg in job["segments"])
        assert abs(sum(seg["ms"] for seg in job["segments"]) - job["wall_ms"]) <= 1.0
        # the run segment splits by the serve.job span's deltas
        assert "split" in job["segments"][-1]
    assert port["fleet"]["coverage_min"] >= 0.99


# ------------------------------------------------------------ the command

@pytest.fixture
def offline(monkeypatch):
    """The wire refuses at once (port 1), so both CLIs read shards alone."""
    monkeypatch.setenv("CCT_SERVE_CLIENT_RETRIES", "0")
    monkeypatch.setenv("CCT_RETRY_BASE_S", "0.01")
    for var in ("CCT_TRACE", "CCT_TRACE_DIR", "CCT_PROF", "CCT_PROF_DIR", "CCT_HISTORY_DIR"):
        monkeypatch.delenv(var, raising=False)


def _run(main, argv, capsys):
    """stdout of one command, or its SystemExit text."""
    try:
        main(argv)
    except SystemExit as exc:
        capsys.readouterr()
        return ("exit", str(exc.code))
    return ("ok", capsys.readouterr().out)


CLIS = {"port": torch_cli.main, "jax": jax_cli.main}


def test_cli_report_and_json_equal_jax(daemon, offline, capsys, tmp_path):
    base = ["critpath", "report", "--dir", daemon["trace_dir"], "--port", "1"]
    outs = {name: _run(main, base, capsys) for name, main in CLIS.items()}
    assert outs["port"] == outs["jax"] and outs["port"][0] == "ok"
    assert "terminal states: done=3" in outs["port"][1]
    outs = {name: _run(main, base + ["--json", "-"], capsys) for name, main in CLIS.items()}
    assert outs["port"] == outs["jax"]
    assert json.loads(outs["port"][1])["fleet"]["jobs"] == 3
    files = {}
    for name, main in CLIS.items():
        path = str(tmp_path / "doc.json")
        files[name] = (_run(main, base + ["--json", path], capsys), open(path, "rb").read())
        os.unlink(path)
    assert files["port"] == files["jax"]


def test_cli_job_by_key_and_id_equal_jax(daemon, offline, capsys):
    key = daemon["subs"][1]["key"]
    job_id = str(daemon["subs"][1]["job_id"])
    for which in (key, job_id):
        argv = ["critpath", "job", which, "--dir", daemon["trace_dir"], "--port", "1"]
        outs = {name: _run(main, argv, capsys) for name, main in CLIS.items()}
        assert outs["port"] == outs["jax"] and outs["port"][0] == "ok"
        assert f"key={key}" in outs["port"][1]


@pytest.mark.parametrize("argv", [
    ["critpath", "report"],                    # an empty directory
    ["critpath", "job", "no-such-key"],        # a key no job has
    ["critpath", "job"],                       # no key at all
])
def test_cli_error_exits_equal_jax(daemon, offline, capsys, tmp_path, argv):
    empty = tmp_path / "empty"
    empty.mkdir()
    shards = str(empty) if argv[1] == "report" else daemon["trace_dir"]
    argv = argv + ["--dir", shards, "--port", "1"]
    outs = {name: _run(main, argv, capsys) for name, main in CLIS.items()}
    assert outs["port"] == outs["jax"] and outs["port"][0] == "exit"
