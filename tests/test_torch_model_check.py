"""The port's interleaving model checker against the JAX package's (CPU).

- **The scenarios hold.** ``tests/test_model_check.py``'s five tests on
  the port's ``utils/interleave.py`` and ``utils/model_check.py`` (built on
  the port's ``serve/journal.py`` and ``Scheduler``): every scenario holds
  at budget 40 with at least 5 schedules; each of the three seeded bugs
  is caught and its schedule replays to the same verdict; the shipped
  fence is clean on the buggy schedule; ``main(["--smoke"])`` returns 0.
- **The explorers agree.** On one toy scenario (two tasks, two tracked
  locks taken in opposite orders, one yield point) the JAX and the port
  ``Explorer`` return equal summaries for the same seed and budget, and
  ``run_schedule`` replays each violating schedule alike.
- **The grammar.** The port's copy of the journal grammar gives the
  verdicts of ``tools/cctlint/protocols.py`` on every record of a port
  journal from the ``submit_kill`` scenario, and on seeded bad records and
  state sequences.
"""

import contextlib
import io
import json
import re

import pytest

from consensuscruncher_tpu.utils import interleave as jax_interleave
from consensuscruncher_tpu.utils import sanitize as jax_sanitize
from consensuscruncher_tpu_torch.serve.scheduler import Scheduler
from consensuscruncher_tpu_torch.utils import interleave, model_check
from consensuscruncher_tpu_torch.utils import sanitize as torch_sanitize
from tools.cctlint import protocols

CONTROLS = {
    "demo-bug": (model_check.build_fence_race_seeded_bug, model_check.build_fence_race,
                 "epoch", 120),
    "poison-control": (model_check.build_poison_quarantine_budget_off,
                       model_check.build_poison_quarantine, "budget", 40),
    "partition-control": (model_check.build_partition_takeover_unguarded,
                          model_check.build_partition_takeover, "split-brain", 120),
}


def _explore(build, *, budget, seed=0, mod=interleave):
    ex = mod.Explorer(build, seed=seed, max_schedules=budget)
    with contextlib.redirect_stderr(io.StringIO()):
        return ex.explore()


def _replay(build, schedule, mod=interleave):
    with contextlib.redirect_stderr(io.StringIO()):
        return mod.run_schedule(build, schedule)[1]


@pytest.mark.parametrize("name", sorted(model_check.SCENARIOS))
def test_scenario_holds_under_bounded_exploration(name):
    res = _explore(model_check.SCENARIOS[name], budget=40)
    assert res["schedules"] >= 5, "exploration degenerated to a line"
    assert res["deadlocks"] == 0
    assert res["violations"] == [], res["violations"]


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_seeded_bug_is_caught_and_replays(control):
    buggy, _shipped, word, budget = CONTROLS[control]
    res = _explore(buggy, budget=budget)
    assert res["violations"], f"{control}: positive control lost"
    schedule, msgs = res["violations"][0]
    assert any(word in m for m in msgs), msgs
    for _ in range(2):  # a deterministic repro on fresh state
        assert _replay(buggy, schedule) == msgs


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_shipped_code_is_clean_on_the_buggy_schedule(control):
    buggy, shipped, _word, budget = CONTROLS[control]
    schedule, _msgs = _explore(buggy, budget=budget)["violations"][0]
    assert _replay(shipped, schedule) == []


def test_cli_smoke_exits_zero(capsys):
    rc = model_check.main(["--smoke"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "demo-bug: CAUGHT" in out
    assert "poison-control: CAUGHT" in out and "partition-control: CAUGHT" in out
    assert "total 360 schedules, 0 violations" in out


def test_cli_replay_flags(capsys):
    schedule, _msgs = _explore(model_check.build_fence_race_seeded_bug,
                               budget=120)["violations"][0]
    with contextlib.redirect_stderr(io.StringIO()):
        rc_bug = model_check.main(["--demo-bug", "--replay", json.dumps(schedule)])
        rc_ok = model_check.main(["--scenario", "fence_race", "--replay", json.dumps(schedule)])
    capsys.readouterr()
    assert rc_bug == 1   # the seeded bug violates on this schedule
    assert rc_ok == 0    # the shipped fence survives the same schedule


def test_run_scenarios_doc_counts_every_schedule(capsys):
    doc = model_check.run_scenarios(["fence_race", "submit_kill"], seed=3, budget=12)
    capsys.readouterr()
    assert doc["violations"] == 0 and doc["deadlocks"] == 0
    assert doc["schedules"] == sum(s["schedules"] for s in doc["scenarios"].values())
    assert doc["counters"]["mc_interleavings"] == doc["schedules"]


# ------------------------------------------------- the explorers agree

def _toy(sanitize):
    """Two tasks take two tracked locks in opposite orders around a yield
    point: some schedules deadlock, and the check flags the order the
    tasks finished in when the second finisher was ``a``."""

    def build(runner):
        lock_x = sanitize.tracked_lock("toy.x")
        lock_y = sanitize.tracked_lock("toy.y")
        done = []

        def task(first, second, name):
            def fn():
                with first:
                    sanitize.yield_point("toy.step")
                    with second:
                        done.append(name)
            return fn

        runner.spawn("a", task(lock_x, lock_y, "a"))
        runner.spawn("b", task(lock_y, lock_x, "b"))
        return lambda: [f"finish order {done}"] if done == ["b", "a"] else []

    return build


def _masked(res):
    """An explorer summary with lock ids (process addresses) masked."""
    return json.loads(re.sub(r", \d+\)", ", ID)", json.dumps(res)))


@pytest.mark.parametrize("seed,budget", [(0, 40), (7, 40), (11, 6)])
def test_explorers_agree_on_a_toy_scenario(seed, budget):
    port = _explore(_toy(torch_sanitize), budget=budget, seed=seed)
    jax = _explore(_toy(jax_sanitize), budget=budget, seed=seed, mod=jax_interleave)
    assert _masked(port) == _masked(jax)
    assert port["deadlocks"] > 0 and port["violations"]
    for schedule, _msgs in port["violations"]:
        assert _masked(_replay(_toy(torch_sanitize), schedule)) == \
            _masked(_replay(_toy(jax_sanitize), schedule, mod=jax_interleave))


def test_run_schedule_installs_the_ports_hook_only():
    seen = []

    def build(runner):
        def task():
            seen.append((torch_sanitize._interleave_hook is runner,
                         jax_sanitize._interleave_hook))
            torch_sanitize.yield_point("toy.step")

        runner.spawn("t", task)
        return lambda: []

    runner, msgs = interleave.run_schedule(build, [])
    assert msgs == [] and runner.trace == ["t", "t"] and seen == [(True, None)]
    assert torch_sanitize._interleave_hook is None


# ------------------------------------------------------------ the grammar

BAD_RECORDS = [
    None, [], {"v": 3, "rec": "job", "id": 1, "state": "accepted"},
    {"v": 2, "rec": "job", "id": 1, "state": "accepted"},
    {"v": 2, "rec": "job", "id": 1, "state": "accepted", "crc": 5},
    {"v": 1, "rec": "blob"}, {"v": 1, "rec": "job", "id": "1", "state": "done"},
    {"v": 1, "rec": "job", "id": 1, "state": "running"},
    {"v": 1, "rec": "marker", "kind": "tombstone"},
    {"v": 1, "rec": "marker", "kind": "fence", "epoch": 2},
    {"v": 1, "rec": "job", "id": 4, "state": "failed"},
]
SEQUENCES = [
    [], ["accepted"], ["accepted", "dispatched", "accepted", "done"], ["done", "accepted"],
    ["failed", "failed"], ["queued"], ["accepted", "running"], ["dispatched", "done", "failed"],
]


def test_grammar_copy_equals_the_declared_tables():
    for name in ("JOURNAL_REC_TYPES", "JOURNAL_STATES", "JOURNAL_TRANSITIONS", "MARKER_KINDS"):
        assert getattr(model_check, name) == getattr(protocols, name), name
    for rec in BAD_RECORDS:
        assert model_check.validate_journal_record(rec) == \
            protocols.validate_journal_record(rec), rec
    for seq in SEQUENCES:
        assert model_check.check_state_sequence(seq) == protocols.check_state_sequence(seq)
    states = list(protocols.JOURNAL_TRANSITIONS) + ["queued"]
    for old in states:
        for new in states:
            assert model_check.validate_transition(old, new) == \
                protocols.validate_transition(old, new)


def test_grammar_on_a_port_journal_from_submit_kill(tmp_path, monkeypatch):
    monkeypatch.setattr(model_check, "_scratch", lambda: str(tmp_path))
    monkeypatch.setattr(model_check.shutil, "rmtree", lambda *a, **k: None)
    # the submitters run ahead of the journal kill (runnable index 1 first)
    _runner, msgs = interleave.run_schedule(model_check.build_submit_kill, [1] * 64)
    assert msgs == []
    path = tmp_path / "journal.ndjson"
    # a rotation snapshot and a drain marker too, on the same journal
    sched = Scheduler(start=False, journal=str(path), device="cpu")
    sched._journal.append_marker("drain")
    sched._journal.close()
    records = [json.loads(ln) for ln in path.read_bytes().split(b"\n") if ln.strip()]
    assert {r["rec"] for r in records} == {"job", "marker"} and len(records) >= 2
    for rec in records:
        assert model_check.validate_journal_record(rec) is None
        assert protocols.validate_journal_record(rec) is None
    assert model_check._journal_grammar_violations(str(path), "j") == []
    with open(path, "ab") as fh:
        fh.write(b'{"v": 1, "rec": "job", "id": 1, "state": "running"}\n')
    assert model_check._journal_grammar_violations(str(path), "j") == [
        "j: job record with unknown state 'running': "
        "{'v': 1, 'rec': 'job', 'id': 1, 'state': 'running'}"]
