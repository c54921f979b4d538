"""The port's ``utils/chaos_conductor.py`` against the JAX package's
``tools/chaos_conductor.py`` (CPU), and live runs of the port's fleet.

The JAX tool is loaded from its path as it stands.  Held without booting
a fleet: the fault constants; ``build_schedule`` for seeds 0, 7 and 13 at
the smoke's 8 and the default 30 random events, with and without
netchaos; ``read_ring_view`` and ``journal_tombstoned`` on whole, torn,
multi-epoch, foreign and missing files; the netchaos spec file's text;
each worker's and router's command line (the port's CLI with ``--device``
in place of ``--backend xla_cpu``, and the shared kernel build directory
once one is set); ``report``'s output and exit code over seeded
violation lists; and ``--device cuda`` without a card failing before any
file or process exists.

Live (``slow``, as the JAX conductor has no tier-1 test either): a fault
of the reference that the port keeps (ROADMAP, "Faults found in the
reference"): once the poison key's quarantine lands on a worker that is
then killed for good, its journal adopted and the worker back as a
zombie dropping the adopted jobs, no node answers for the poison key.
The forced sequence on two workers gives both packages that one
violation, word for word.  ``--smoke --device cpu`` (about a minute) and
``--netchaos --smoke --workers 2 --device cpu`` land every structural
event and hold every invariant, failing on that one alone exactly when
their schedule kills the quarantine's holder (the key hashes the
workdir, so that varies from run to run).
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import sys
import time

import pytest
import torch

from consensuscruncher_tpu_torch.utils import chaos_conductor as conductor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

spec = importlib.util.spec_from_file_location(
    "reference_chaos_conductor", os.path.join(REPO, "tools", "chaos_conductor.py"))
jax_conductor = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax_conductor)


@pytest.fixture(autouse=True)
def _netchaos_env(monkeypatch):
    """A netchaos conductor arms this process's clients through the
    environment; every test leaves it as it found it."""
    for var in ("CCT_NETCHAOS", "CCT_NETCHAOS_NODE", "CCT_FAULTS"):
        monkeypatch.delenv(var, raising=False)


def _pair(tmp_path, seed=7, **kw):
    port = conductor.Conductor(str(tmp_path / "port"), seed, device="cpu", **kw)
    ref = jax_conductor.Conductor(str(tmp_path / "ref"), seed, **kw)
    return port, ref


def test_fault_constants_equal_jax():
    for name in ("WORKER_FAULTS", "ROUTER_FAULTS", "POISON_FAULT", "FLEET_ATTEMPT_BUDGET"):
        assert getattr(conductor, name) == getattr(jax_conductor, name), name


@pytest.mark.parametrize("netchaos", [False, True])
@pytest.mark.parametrize("seed", [0, 7, 13])
def test_build_schedule_equals_jax(tmp_path, seed, netchaos):
    for events in (8, 30):
        port, ref = _pair(tmp_path / str(events), seed, workers=3, max_unique_jobs=3,
                          netchaos=netchaos)
        sched = port.build_schedule(events)
        assert sched == ref.build_schedule(events)
        assert sched[0] == "submit"
        assert {"kill_active_router", "perm_kill_worker", "zombie_return", "add_member",
                "decommission_member", "poison_submit", "disk_full"} <= set(sched)
        # the rest of the seeded stream (the events' own draws) agrees too
        assert port.rng.random() == ref.rng.random()


def _view_files(tmp_path) -> dict:
    docs = [{"epoch": 1, "router": "r0", "members": {"w0": "a"}},
            {"epoch": 3, "router": "r1", "members": {"w0": "a"}},
            {"epoch": 2, "router": "r0", "members": {}}]
    lines = [json.dumps(d).encode() for d in docs]
    files = {"whole": b"\n".join(lines) + b"\n",
             "torn": b"\n".join(lines[:2]) + b"\n" + lines[2][:17],
             "multi_epoch_torn_best": lines[0] + b"\n" + lines[1][:-3] + b"\n",
             "foreign": b'{"no": "epoch"}\n[1, 2]\nnot json\n\n',
             "empty": b""}
    out = {}
    for name, data in files.items():
        path = tmp_path / f"{name}.view"
        path.write_bytes(data)
        out[name] = str(path)
    out["missing"] = str(tmp_path / "missing.view")
    return out


def test_read_ring_view_equals_jax(tmp_path):
    files = _view_files(tmp_path)
    for name, path in files.items():
        assert conductor.read_ring_view(path) == jax_conductor.read_ring_view(path), name
    assert conductor.read_ring_view(files["whole"])["epoch"] == 3
    assert conductor.read_ring_view(files["multi_epoch_torn_best"])["epoch"] == 1
    assert conductor.read_ring_view(files["missing"]) is None


def test_journal_tombstoned_equals_jax(tmp_path):
    job = {"v": 1, "rec": "job", "id": 1, "state": "accepted", "key": "k"}
    marker = {"v": 1, "rec": "marker", "kind": "adopted", "by": "r0", "epoch": 2}
    other = {"v": 1, "rec": "marker", "kind": "suspect", "key": "k", "attempt": 1}
    line = lambda d: json.dumps(d).encode() + b"\n"  # noqa: E731
    files = {"whole": line(job) + line(marker),
             "no_marker": line(job) + line(other),
             "torn_marker": line(job) + line(marker)[:-9],
             "adopted_word_elsewhere": line(dict(job, note="adopted")),
             "marker_after_epochs": line(job) + line(other) + line(job) + line(marker),
             "empty": b""}
    for name, data in files.items():
        path = tmp_path / f"{name}.journal"
        path.write_bytes(data)
        assert conductor.journal_tombstoned(str(path)) == \
            jax_conductor.journal_tombstoned(str(path)), name
    missing = str(tmp_path / "missing.journal")
    assert conductor.journal_tombstoned(missing) is jax_conductor.journal_tombstoned(missing)
    assert conductor.journal_tombstoned(str(tmp_path / "whole.journal"))
    assert not conductor.journal_tombstoned(str(tmp_path / "torn_marker.journal"))


def test_netchaos_spec_text_equals_jax(tmp_path):
    port, ref = _pair(tmp_path, 13, netchaos=True)
    assert os.environ["CCT_NETCHAOS"] == "@" + ref.netchaos_spec
    for rules in ([], ["*<->w1=partition"], ["r1->r0=partition"],
                  ["client->r0=corrupt@3", "client->r1=corrupt@3"]):
        with contextlib.redirect_stdout(io.StringIO()) as pout:
            port._write_netchaos(rules)
        with contextlib.redirect_stdout(io.StringIO()) as rout:
            ref._write_netchaos(rules)
        assert open(port.netchaos_spec).read() == open(ref.netchaos_spec).read()
        assert pout.getvalue() == rout.getvalue()


def test_spawn_command_lines_follow_jax(tmp_path):
    """Each spawn's command line is the JAX tool's after its interpreter
    prefix, with ``--device D`` for ``--backend xla_cpu``, and on the card
    the shared kernel build directory as ``--compile_cache``; the
    environment carries the fault arming, tracing and the retry budget."""
    port, ref = _pair(tmp_path, workers=2)
    seen = {}
    for name, obj in (("port", port), ("ref", ref)):
        calls = []
        obj._popen = lambda tag, argv, fault, calls=calls: calls.append((tag, argv, fault))
        obj.next_worker_fault = "serve.dispatch=fail@1"
        obj._spawn_worker("w0")
        obj._spawn_router("r1", standby=True)
        seen[name] = calls
    (pw, pr), (rw, rr) = seen["port"], seen["ref"]
    assert pw[1][:3] == [sys.executable, "-m", "consensuscruncher_tpu_torch.cli"]
    worker = [a.replace(str(tmp_path / "port"), "W") for a in pw[1][3:]]
    want = [a.replace(str(tmp_path / "ref"), "W") for a in rw[1][3:]]
    i = want.index("--backend")
    assert want[i:i + 2] == ["--backend", "xla_cpu"]
    want[i:i + 2] = ["--device", "cpu"]
    assert worker == want
    assert pw[2] == rw[2] == "serve.poison=exit@99,serve.dispatch=fail@1"
    assert [a.replace(str(tmp_path / "port"), "W") for a in pr[1][3:]] == \
        [a.replace(str(tmp_path / "ref"), "W") for a in rr[1][3:]]
    port.build_dir = str(tmp_path / "build")
    port._popen = lambda tag, argv, fault: seen.update(card=argv)
    port._spawn_worker("w1")
    assert seen["card"][-2:] == ["--compile_cache", str(tmp_path / "build")]


def test_child_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("CCT_FAULTS", "serve.worker=fail@9")
    monkeypatch.setenv("PYTHONPATH", "elsewhere")
    port = conductor.Conductor(str(tmp_path), 7, device="cpu")
    captured = {}

    def fake_popen(argv, env, stdout, stderr):
        captured.update(env)
        stdout.close()

    monkeypatch.setattr(conductor.subprocess, "Popen", fake_popen)
    with contextlib.redirect_stdout(io.StringIO()):
        port._popen("w0", ["x"], "serve.poison=exit@99")
    assert captured["PYTHONPATH"] == os.pathsep.join([REPO, "elsewhere"])
    assert captured["CCT_FAULTS"] == "serve.poison=exit@99"
    assert captured["CCT_TRACE"] == "1" and captured["CCT_TRACE_DIR"] == port.trace_dir
    assert captured["CCT_SERVE_MAX_FLEET_ATTEMPTS"] == "3"


def _seeded(obj, case):
    obj.acked = [{"key": "a", "out": "/x/job0"}, {"key": "a", "out": "/x/job0"},
                 {"key": "b", "out": "/x/job1"}]
    obj.takeovers_seen, obj.adoptions_seen = 2, 1
    obj.quarantines_seen, obj.brownouts_seen, obj.last_epoch = 1, 1, 6
    obj.partitions_seen, obj.asym_partitions_seen = 1, 1
    obj.flaps_seen, obj.wire_crc_seen = 1, 14
    if case != "no_summary":
        obj.trace_summary = {"spans": 201, "traces": 142, "orphans": 0}
    obj.violations = {"none": [], "no_summary": [],
                      "one": ["acked key p unresolvable after 90s: unknown job_id"],
                      "many": ["[event 3:submit] trace: x", "no takeover within 60s of "
                               "killing active r0", "poison key p ended 'done'"]}[case]


@pytest.mark.parametrize("netchaos", [False, True])
@pytest.mark.parametrize("case", ["none", "no_summary", "one", "many"])
def test_report_equals_jax(tmp_path, case, netchaos):
    port, ref = _pair(tmp_path, netchaos=netchaos)
    got = {}
    for name, obj in (("port", port), ("ref", ref)):
        _seeded(obj, case)
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = obj.report()
        got[name] = (rc, out.getvalue(), err.getvalue())
    assert got["port"] == got["ref"]
    assert got["port"][0] == (1 if case in ("one", "many") else 0)


def test_no_card_fails_before_any_spawn(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("holds the refusal on a host without a card")
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()) as out:
        rc = conductor.main(["--workdir", str(tmp_path / "chaos"), "--smoke"])
    assert rc == 1
    assert err.getvalue().startswith("chaos: FAIL CUDA is not available")
    assert "booting fleet" not in out.getvalue()
    assert not os.path.exists(tmp_path / "chaos")


def _live(tmp_path, *argv) -> tuple[int, str, conductor.Conductor]:
    """``main``'s run with the conductor it built kept for its counters."""
    built = []
    real = conductor.Conductor

    class Kept(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    out = io.StringIO()
    conductor.Conductor = Kept
    try:
        with contextlib.redirect_stdout(out):
            rc = conductor.main(["--workdir", str(tmp_path / "chaos"), "--smoke",
                                 "--device", "cpu", *argv])
    finally:
        conductor.Conductor = real
    return rc, out.getvalue(), built[0]


def _marker(path, kind, **fields) -> None:
    with open(path, "a") as fh:
        fh.write(json.dumps({"rec": "marker", "kind": kind, **fields}) + "\n")


@pytest.mark.parametrize("case", ["clean", "tripped", "violation_without_the_conditions",
                                  "conditions_without_the_violation", "one_more_violation",
                                  "holder_still_dead"])
def test_reference_poison_fault_judges_a_finished_run(tmp_path, case):
    """The one judgement of a run against the reference's lost poison
    verdict, which the live legs and the card's smoke share: the fault
    kept only under its conditions (the quarantine's holder adopted and
    back) and only as the poison key's ``unknown job_id``."""
    c = conductor.Conductor(str(tmp_path / "chaos"), 7, workers=3, device="cpu")
    key = "k" * 16
    c.poison = {"key": key, "out": str(tmp_path / "poison")}
    lost = f"acked key {key} unresolvable after 90s: unknown job_id"
    holder = c.workers["w1"]
    os.makedirs(os.path.dirname(holder["journal"]), exist_ok=True)
    _marker(c.workers["w0"]["journal"], "suspect", key=key, attempt=1)
    _marker(holder["journal"], "quarantined", key=key)
    if case != "clean":
        _marker(holder["journal"], "adopted", by="r0")
    holder["permanent"] = case == "holder_still_dead"
    c.violations = {"clean": [], "tripped": [lost], "violation_without_the_conditions": [lost],
                    "conditions_without_the_violation": [],
                    "one_more_violation": [lost, "job0 digest differs"],
                    "holder_still_dead": [lost]}[case]
    rc = 1 if c.violations else 0
    if case == "clean":
        assert conductor.reference_poison_fault(c, rc) is None
    elif case == "tripped":
        assert conductor.reference_poison_fault(c, rc) == "w1"
        with pytest.raises(AssertionError):
            conductor.reference_poison_fault(c, 0)
    else:
        if case == "violation_without_the_conditions":
            os.unlink(holder["journal"])
            _marker(holder["journal"], "quarantined", key=key)
        with pytest.raises(AssertionError, match="poison fault"):
            conductor.reference_poison_fault(c, rc)


@pytest.mark.slow
def test_smoke_on_the_cpu_holds_every_invariant(tmp_path):
    """The ``--smoke`` leg holds every invariant, but for the reference's
    lost poison verdict where its schedule trips it."""
    rc, out, c = _live(tmp_path)
    conductor.reference_poison_fault(c, rc)
    assert c.takeovers_seen >= 1 and c.adoptions_seen >= 1
    assert c.quarantines_seen >= 1 and c.brownouts_seen >= 1
    assert c.trace_summary["orphans"] == 0 and c.trace_summary["spans"] > 0
    assert ("chaos: OK — every invariant held through the schedule" in out) == (rc == 0)


@pytest.mark.slow
def test_netchaos_smoke_keeps_the_reference_poison_fault(tmp_path):
    """The netchaos leg at seed 7 holds every invariant but one, which
    fails exactly when the poison key's quarantine lands on the worker the
    schedule then kills for good (the key hashes the workdir, so where the
    lineage ends varies between checkouts): no node answers for the key
    after the adoption and the zombie's drop, as in the reference."""
    rc, out, c = _live(tmp_path, "--netchaos", "--workers", "2")
    conductor.reference_poison_fault(c, rc)
    assert re.search(r"zombie w\d rejoined; dropped [1-9]\d* adopted job\(s\)", out)
    assert c.takeovers_seen >= 1 and c.adoptions_seen >= 1
    assert c.quarantines_seen >= 1 and c.brownouts_seen >= 1
    assert c.partitions_seen >= 1 and c.asym_partitions_seen >= 1 and c.wire_crc_seen >= 1
    assert c.trace_summary["orphans"] == 0


def _quarantined_then_adopted(c) -> tuple[str, list]:
    """The reference's fault, forced: the poison key quarantined, its
    holder killed for good and its journal adopted, the holder back as a
    zombie that the router sees up again; then the key polled as the
    conductor's finish polls it (for 20 s, not 90)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        c.boot()
        try:
            c.ev_submit()
            c.ev_poison_submit()
            holder = conductor._quarantine_holder(c)
            w = c.workers[holder]
            w["alive"], w["permanent"] = False, True
            c._kill9(w["proc"], f"worker {holder} (PERMANENT)")
            deadline = time.monotonic() + 120
            while not conductor.journal_tombstoned(w["journal"]):
                assert time.monotonic() < deadline, "no adoption"
                time.sleep(0.5)
            c.ev_zombie_return()
            while c.check_client.request({"op": "healthz"})["health"]["fleet"]["up"] < 2:
                assert time.monotonic() < deadline + 60, "the zombie never came up"
                time.sleep(0.5)
            c._poll_status(c.poison["key"], deadline_s=20.0)
        finally:
            c.teardown()
    return out.getvalue(), list(c.violations)


@pytest.mark.slow
def test_poison_quarantined_on_an_adopted_worker_is_lost_in_both(tmp_path):
    """Four facts of the reference's fault, on two workers: the input (the
    poison key quarantined on a worker that is killed for good, adopted
    and returns as a zombie), the first thing that differs from a whole
    fleet (a poll of the key), the reference's answer and the port's: both
    ``unknown job_id``, the run's only violation."""
    port, ref = _pair(tmp_path, workers=2, max_unique_jobs=3)
    got = {}
    for name, c in (("port", port), ("ref", ref)):
        out, violations = _quarantined_then_adopted(c)
        assert c.quarantines_seen == 1, out[-3000:]
        assert re.search(r"dropped [1-9]\d* adopted job\(s\)", out), out[-3000:]
        assert len(violations) == 1, violations
        lost = conductor.POISON_LOST.format(key=c.poison["key"]).replace("90s", "20s")
        assert re.fullmatch(lost, violations[0]), violations
        got[name] = violations[0].split(": ", 1)[1]
    assert got["port"] == got["ref"]
