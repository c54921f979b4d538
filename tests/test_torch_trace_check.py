"""The port's ``utils/trace_check.py`` against the JAX package's
``tools/trace_check.py`` (CPU).

The JAX tool is loaded from its path as it stands.  Held: every fleet case
of ``tests/test_fleet_trace.py`` (a connected tree over a failover, a
virtual pid that died unflushed, an orphan and a missing anchor beside a
legitimately anchorless background span, journals that disagree on a
key's trace id and a journal-terminal key with no ``serve.terminal``
event, a shard directory with a torn line, an empty trace) gives both
checkers the same problem list, the same ``fleet_summary`` and the same
``main`` exit code and output; malformed Chrome traces give the same
schema problems and exit codes; and the trace a traced ``consensus
--device cpu`` run of the port exports is schema-valid to both.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest

from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.serve.journal import Journal
from consensuscruncher_tpu_torch.utils import trace_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")

spec = importlib.util.spec_from_file_location(
    "reference_trace_check", os.path.join(REPO, "tools", "trace_check.py"))
jax_trace_check = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax_trace_check)

KEY = "k" * 16


def _xspan(name, pid, span_id, trace="t1", hop=0, ff=None, ts=1000, **args):
    a = {"trace_id": trace, "hop": hop}
    if ff is not None:
        a["follows_from"] = ff
    a.update(args)
    return {"name": name, "cat": "cct", "ph": "X", "ts": ts, "dur": 10,
            "pid": pid, "tid": 1, "id": span_id, "args": a}


def _ievent(name, pid, trace="t1", ts=1500):
    return {"name": name, "cat": "cct", "ph": "i", "s": "t", "ts": ts,
            "pid": pid, "tid": 1, "args": {"trace_id": trace}}


def _write_trace(path, events):
    with open(path, "w") as fh:
        json.dump({"traceEvents": events}, fh)
    return str(path)


def _journal(path, trace_id, terminal=None):
    j = Journal(str(path))
    j.append_job(41, "accepted", key=KEY, spec={"x": 1}, trace_id=trace_id, trace=None)
    if terminal:
        j.append_job(41, terminal, outputs={})
    j.close()
    return str(path)


def _connected(tmp_path):
    events = [
        _xspan("route.submit", 50, 1, hop=0, ts=900),
        _xspan("serve.submit", 100, 5, hop=2, ts=1000, ff={"span": 2, "pid": 50}),
        _xspan("route.resubmit", 50, 9, hop=1, ts=2000, ff={"span": 5, "pid": 100}),
        _xspan("serve.submit", 300, 12, hop=3, ts=2100, ff={"span": 10, "pid": 50}),
        _ievent("serve.terminal", 300, ts=2500),
    ]
    return (_write_trace(tmp_path / "fleet.json", events),
            [_journal(tmp_path / "w0.journal", "t1"),
             _journal(tmp_path / "w1.journal", "t1", terminal="done")])


def _virtual_pid(tmp_path):
    events = [
        _xspan("serve.submit", 50, 1, hop=0, ts=900, trace="t0"),
        _xspan("route.resubmit", 200, 9, hop=1, ts=2000, ff={"span": 5, "pid": 100}),
        _xspan("serve.replay", 300, 12, hop=2, ts=2100, ff={"span": 5, "pid": 100}),
    ]
    return _write_trace(tmp_path / "fleet.json", events), []


def _orphans(tmp_path):
    events = [_xspan("serve.submit", 100, 5, hop=0, ts=1000),
              _xspan("serve.job", 999, 20, hop=5, ts=3000)]
    return _write_trace(tmp_path / "fleet.json", events), []


def _anchorless(tmp_path):
    return _write_trace(tmp_path / "anchorless.json", [_xspan("serve.job", 50, 1, ts=100)]), []


def _background(tmp_path):
    return _write_trace(tmp_path / "background.json",
                        [_xspan("route.probe", 50, 1, ts=100)]), []


def _disagreement(tmp_path):
    trace = _write_trace(tmp_path / "fleet.json", [_xspan("serve.submit", 100, 5, ts=1000)])
    return trace, [_journal(tmp_path / "w0.journal", "t1"),
                   _journal(tmp_path / "w1.journal", "t2", terminal="done")]


def _lost_terminal(tmp_path):
    trace = _write_trace(tmp_path / "fleet.json", [_xspan("serve.submit", 100, 5, ts=1000)])
    return trace, [_journal(tmp_path / "w3.journal", "t1", terminal="done")]


def _terminal_without_trace(tmp_path):
    trace = _write_trace(tmp_path / "fleet.json", [_xspan("serve.submit", 100, 5, ts=1000)])
    return trace, [_journal(tmp_path / "w3.journal", "t9", terminal="failed")]


def _shard_dir(tmp_path):
    shards = tmp_path / "shards"
    shards.mkdir()
    with open(shards / "trace-100.ndjson", "w") as fh:
        fh.write(json.dumps(_xspan("serve.submit", 100, 5)) + "\n")
        fh.write('{"torn line\n')  # kill -9 mid-write: skipped, not fatal
    with open(shards / "trace-200.ndjson", "w") as fh:
        fh.write(json.dumps(_xspan("route.submit", 200, 9, hop=1,
                                   ff={"span": 5, "pid": 100})) + "\n")
    return str(shards), []


def _empty(tmp_path):
    return _write_trace(tmp_path / "fleet.json", []), []


def _unreadable(tmp_path):
    return str(tmp_path / "missing.json"), []


FLEET_CASES = {"connected_tree": _connected, "virtual_pid": _virtual_pid,
               "orphans": _orphans, "anchorless_job": _anchorless,
               "anchorless_background": _background, "journal_disagreement": _disagreement,
               "lost_terminal": _lost_terminal, "terminal_without_trace": _terminal_without_trace,
               "shard_directory": _shard_dir, "empty_trace": _empty,
               "unreadable": _unreadable}

# what the reference's own tests expect of each case, held here too so
# that two equally wrong checkers cannot pass
EXPECT = {"connected_tree": lambda ps: ps == [],
          "virtual_pid": lambda ps: ps == [],
          "orphans": lambda ps: any("ORPHANED" in p and "serve.job" in p for p in ps),
          "anchorless_job": lambda ps: any("no causal anchor" in p for p in ps),
          "anchorless_background": lambda ps: ps == [],
          "journal_disagreement": lambda ps: any("disagree on trace_id" in p for p in ps),
          "lost_terminal": lambda ps: any("no serve.terminal" in p for p in ps),
          "terminal_without_trace": lambda ps: any("has no events at all" in p for p in ps),
          "shard_directory": lambda ps: ps == [],
          "empty_trace": lambda ps: any("no spans" in p for p in ps),
          "unreadable": lambda ps: len(ps) == 1 and ps[0].startswith("unreadable")}


def _main(module, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = module.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_fleet_case_equals_jax(case, tmp_path):
    trace, journals = FLEET_CASES[case](tmp_path)
    got = trace_check.check_fleet(trace, journals)
    assert got == jax_trace_check.check_fleet(trace, journals)
    assert EXPECT[case](got), got
    summary = trace_check.fleet_summary(trace, journals)
    assert summary == jax_trace_check.fleet_summary(trace, journals)
    if case == "connected_tree":
        assert summary["orphans"] == 0 and summary["terminal_keys"] == 1
    if case == "shard_directory":
        assert summary["spans"] == 2
    argv = ["--fleet", trace] + (["--journals", *journals] if journals else [])
    port = _main(trace_check, argv)
    assert port == _main(jax_trace_check, argv)
    assert port[0] == (1 if got else 0)


def _merged(tmp_path):
    ack = _xspan("serve.submit", 100, 5, ts=1000)
    ack["node"] = "w0"
    resub = _xspan("route.resubmit", 200, 9, ts=2000, ff={"span": 5, "pid": 100})
    resub["node"] = "r0"
    out = str(tmp_path / "merged.json")
    obs_trace.merge_fleet_trace([[ack, resub], [ack]], out)
    return out


SCHEMA_CASES = {
    "merged_fleet": _merged,
    "bare_array": lambda tmp_path: str(_dump(tmp_path, [_xspan("serve.submit", 1, 1)])),
    "bad_events": lambda tmp_path: str(_dump(tmp_path, {"traceEvents": [
        "not an object",
        {"name": "", "ph": "X", "ts": "soon", "pid": True, "tid": 1},
        {"name": "a", "ph": "Q", "ts": 1, "pid": 1, "tid": 1},
        {"name": "a", "ph": "X", "ts": 1, "pid": 1, "tid": 1, "dur": -1, "args": {}},
        {"name": "a", "ph": "i", "ts": 1, "pid": 1, "tid": 1},
        {"name": "a", "ph": "s", "ts": 1, "pid": 1, "tid": 1, "id": 1.5}]})),
    "too_many_problems": lambda tmp_path: str(_dump(tmp_path, {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 1, "pid": 1, "tid": 1}] * 60})),
    "no_trace_events": lambda tmp_path: str(_dump(tmp_path, {"events": []})),
    "scalar_top_level": lambda tmp_path: str(_dump(tmp_path, 7)),
    "not_json": lambda tmp_path: str(_text(tmp_path, "{nope")),
    "unreadable": lambda tmp_path: str(tmp_path / "missing.json"),
}


def _dump(tmp_path, doc):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(doc))
    return path


def _text(tmp_path, text):
    path = tmp_path / "t.json"
    path.write_text(text)
    return path


@pytest.mark.parametrize("case", sorted(SCHEMA_CASES))
def test_schema_case_equals_jax(case, tmp_path):
    path = SCHEMA_CASES[case](tmp_path)
    got = trace_check.check_trace(path)
    assert got == jax_trace_check.check_trace(path)
    assert (got == []) == (case in ("merged_fleet", "bare_array"))
    assert _main(trace_check, [path]) == _main(jax_trace_check, [path])


@pytest.mark.parametrize("argv", [[], ["--fleet"]])
def test_usage_and_exit_code_equal_jax(argv):
    port = _main(trace_check, argv)
    assert port == _main(jax_trace_check, argv)
    assert port[0] == 2 and port[2].startswith("usage: trace_check.py")


def test_traced_port_run_exports_a_valid_trace(tmp_path):
    """A ``consensus --device cpu`` run of the port under ``CCT_TRACE=1``
    leaves shards whose ``trace export`` both checkers pass, holding the
    one-shot stream path's backbone (the command, the SSCS device loop and
    its batches) under one trace id."""
    trace_dir, out = tmp_path / "traces", tmp_path / "trace.json"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CCT_TRACE", "CCT_PROF", "CCT_HISTORY"))}
    env.update(CCT_TRACE="1", CCT_TRACE_DIR=str(trace_dir))
    for argv in (["consensus", "-i", SAMPLE, "-o", str(tmp_path), "-n", "golden",
                  "--scorrect", "True", "--device", "cpu"],
                 ["trace", "export", "--dir", str(trace_dir), "--out", str(out)]):
        proc = subprocess.run([sys.executable, "-m", "consensuscruncher_tpu_torch.cli", *argv],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
    assert trace_check.check_trace(str(out)) == []
    assert jax_trace_check.check_trace(str(out)) == []
    events = json.loads(out.read_text())["traceEvents"]
    assert {"cli.consensus", "sscs.device_loop", "device.batch"} <= {e["name"] for e in events}
    root = next(e for e in events if e["name"] == "cli.consensus")
    batches = [e for e in events if e["name"] in ("sscs.device_loop", "device.batch")]
    assert all(e["args"]["trace_id"] == root["args"]["trace_id"] for e in batches)
