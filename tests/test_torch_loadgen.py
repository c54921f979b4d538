"""The port's load generator against the JAX package's ``tools/loadgen.py``
(CPU), and live runs against the port's daemon and fleet.

The JAX tool is loaded from its path as it stands.  Held: the non-slow
cases of ``tests/test_loadgen.py`` (the mix parser and its refusals, the
family-size PMF, the per-qos metric-delta helpers, the knee, the inputs of
every class) give the JAX functions' results, as do the popularity
parser, the zipf draw and the fleet helpers; ``make_inputs`` writes the
same BAM bytes for the same seed.  Live: ``--smoke --device cpu`` against a
spawned port daemon (sampling profiler on) and, through ``--sweep_workers
1,2``, against spawned one- and two-worker ``route`` fleets each give an
artifact with the top-level keys of ``BENCH_LOADGEN_r12.json`` (less the
fleet's keys for one daemon), no lost job, a knee above 0 and the SLO
classes, and each passes the port's perf gate against itself, as does the
sweep's combined artifact (the keys of ``BENCH_LOADGEN_r09.json``);
without a card the default ``--device cuda`` child exits before serving
and the run fails naming its exit code, writing no artifact.
"""

import hashlib
import importlib.util
import json
import os
import random
import subprocess
import sys

import pytest

from consensuscruncher_tpu_torch.utils import loadgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

spec = importlib.util.spec_from_file_location("reference_loadgen",
                                              os.path.join(REPO, "tools", "loadgen.py"))
jax_loadgen = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax_loadgen)

FLEET_KEYS = {"fleet", "nodes_final", "router_cumulative"}


def test_constants_equal_jax():
    assert loadgen.DEFAULT_FAMILY_PMF == jax_loadgen.DEFAULT_FAMILY_PMF
    assert loadgen.QOS_CLASSES == jax_loadgen.QOS_CLASSES
    assert loadgen._CLASS_FRAGMENTS == jax_loadgen._CLASS_FRAGMENTS
    assert loadgen._CLASS_FRAGMENTS_SMOKE == jax_loadgen._CLASS_FRAGMENTS_SMOKE


def test_parse_mix_equals_jax():
    for text in ("a:interactive:6,b:batch:3", "alpha:interactive:6,beta:batch:3,"
                 "gamma:scavenger:1", " x:scavenger:0.5 ,"):
        assert loadgen._parse_mix(text) == jax_loadgen._parse_mix(text)
    assert loadgen._parse_mix("a:interactive:6,b:batch:3") == \
        [("a", "interactive", 6.0), ("b", "batch", 3.0)]


@pytest.mark.parametrize("text", ["a:warp:1", "a:interactive:0", "nonsense", "", "a:batch:x"])
def test_parse_mix_refusals_equal_jax(text):
    with pytest.raises(SystemExit) as got:
        loadgen._parse_mix(text)
    with pytest.raises(SystemExit) as want:
        jax_loadgen._parse_mix(text)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("text", ["uniform", "", "zipf:1.1", "zipf:0", "zipf:x", "pareto"])
def test_parse_popularity_equals_jax(text):
    def outcome(tool):
        try:
            return tool._parse_popularity(text)
        except SystemExit as exc:
            return ("exit", str(exc))

    assert outcome(loadgen) == outcome(jax_loadgen)


def test_zipf_pick_equals_jax():
    got = [loadgen._zipf_pick(random.Random(3), 21, 1.1) for _ in range(5)]
    rng, jrng = random.Random(9), random.Random(9)
    assert [loadgen._zipf_pick(rng, 21, 1.1) for _ in range(200)] == \
        [jax_loadgen._zipf_pick(jrng, 21, 1.1) for _ in range(200)]
    assert got == [jax_loadgen._zipf_pick(random.Random(3), 21, 1.1) for _ in range(5)]


def test_family_pmf_roundtrip_equals_jax(tmp_path):
    path = tmp_path / "fam.txt"
    path.write_text("family_size\tcount\n1\t60\n3\t30\n8\t10\n")
    pmf = loadgen._load_family_pmf(str(path))
    assert pmf == jax_loadgen._load_family_pmf(str(path)) == {1: 0.6, 3: 0.3, 8: 0.1}
    for draws in (24, 500):
        mean = loadgen._sample_mean_family(random.Random(7), pmf, draws=draws)
        assert 1.0 <= mean <= 8.0
        assert mean == jax_loadgen._sample_mean_family(random.Random(7), pmf, draws=draws)
    empty = tmp_path / "empty.txt"
    empty.write_text("family_size\tcount\n")
    with pytest.raises(SystemExit, match="empty family histogram"):
        loadgen._load_family_pmf(str(empty))


def _doc(done_a, done_b, counts_a, counts_b, routed=None):
    doc = {"labeled": {"counters": {"tenant_jobs_done": [
        {"labels": {"tenant": "a", "qos": "batch"}, "value": done_a},
        {"labels": {"tenant": "b", "qos": "batch"}, "value": done_b},
        {"labels": {"tenant": "a", "qos": "interactive"}, "value": 1},
    ]}, "histograms": {"tenant_job_wall_s": [
        {"labels": {"tenant": "a", "qos": "batch"},
         "buckets": [1.0, 2.0], "counts": counts_a},
        {"labels": {"tenant": "b", "qos": "batch"},
         "buckets": [1.0, 2.0], "counts": counts_b},
    ]}}, "cumulative": {"recompiles": 3}}
    if routed is not None:
        node = {"labeled": doc["labeled"], "cumulative": {"recompiles": 2}}
        doc = {"labeled": {"counters": {
            "node_jobs_routed": [{"labels": {"node": n}, "value": v}
                                 for n, v in routed.items()],
            "node_steals": [{"labels": {"node": "w0"}, "value": 1}],
            "node_resubmits": []}},
            "nodes": {"w0": node, "w1": node, "w2": None}}
    return doc


def test_metrics_delta_helpers_equal_jax():
    before = _doc(1, 0, [1, 0, 0], [0, 0, 0])
    after = _doc(3, 2, [1, 0, 0], [0, 2, 1])
    for name in ("tenant_jobs_done", "tenant_jobs_shed"):
        assert loadgen._counter_by_qos(after, name) == jax_loadgen._counter_by_qos(after, name)
    assert loadgen._counter_by_qos(after, "tenant_jobs_done")["batch"] == 5
    walls = loadgen._wall_hist_by_qos(after)
    assert walls == jax_loadgen._wall_hist_by_qos(after)
    assert walls["batch"]["counts"] == [1, 2, 1]
    want = jax_loadgen._hist_delta(jax_loadgen._wall_hist_by_qos(before)["batch"],
                                   walls["batch"])
    assert loadgen._hist_delta(loadgen._wall_hist_by_qos(before)["batch"],
                               walls["batch"]) == want == {"buckets": [1.0, 2.0],
                                                           "counts": [0, 2, 1]}
    assert loadgen._hist_delta(None, walls["batch"]) == jax_loadgen._hist_delta(
        None, walls["batch"])
    a, b = {"x": 5, "y": 2}, {"x": 1}
    assert loadgen._delta(a, b) == jax_loadgen._delta(a, b) == {"x": 4, "y": 2}
    assert loadgen._recompiles_total(after) == jax_loadgen._recompiles_total(after) == 3


def test_fleet_helpers_equal_jax():
    before = _doc(1, 0, [1, 0, 0], [0, 0, 0], routed={"w0": 1})
    after = _doc(3, 2, [1, 0, 0], [0, 2, 1], routed={"w0": 4, "w1": 2})
    for name in ("node_jobs_routed", "node_steals", "node_resubmits"):
        assert loadgen._counter_by_node(after, name) == \
            jax_loadgen._counter_by_node(after, name)
    assert loadgen._wall_hist_by_node(after) == jax_loadgen._wall_hist_by_node(after)
    assert loadgen._recompiles_total(after) == jax_loadgen._recompiles_total(after) == 4
    got = loadgen._node_breakdown(before, after)
    assert got == jax_loadgen._node_breakdown(before, after)
    assert got["w0"]["jobs_routed"] == 3 and got["w1"]["jobs_finished"] == 3
    plain = _doc(1, 0, [1, 0, 0], [0, 0, 0])
    assert loadgen._node_breakdown(plain, plain) is None


def _lv(rate, shed_ratio, thru, lost=0):
    return {"offered_jobs_per_s": rate,
            "aggregate": {"shed_ratio": shed_ratio, "lost": lost,
                          "throughput_jobs_per_s": thru}}


@pytest.mark.parametrize("levels,shed_knee", [
    ([_lv(1, 0.0, 0.9), _lv(2, 0.02, 1.8), _lv(4, 0.4, 2.1), _lv(8, 0.7, 1.9)], 0.05),
    ([_lv(1, 0.0, 0.9, lost=1)], 0.05),
    ([_lv(0.5, 0.1, 0.4), _lv(1, 0.2, 0.8)], 0.15),
    ([], 0.05),
])
def test_knee_estimate_equals_jax(levels, shed_knee):
    assert loadgen.knee_estimate(levels, shed_knee) == \
        jax_loadgen.knee_estimate(levels, shed_knee)


def test_knee_estimate_picks_last_unshed_level():
    levels = [_lv(1, 0.0, 0.9), _lv(2, 0.02, 1.8), _lv(4, 0.4, 2.1), _lv(8, 0.7, 1.9)]
    knee = loadgen.knee_estimate(levels, shed_knee=0.05)
    assert knee["knee_offered_jobs_per_s"] == 2
    assert knee["max_throughput_jobs_per_s"] == 2.1
    assert loadgen.knee_estimate([_lv(1, 0.0, 0.9, lost=1)], 0.05)[
        "knee_offered_jobs_per_s"] is None


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.mark.parametrize("per_class,seed,smoke", [(1, 3, True), (2, 0, False)])
def test_make_inputs_writes_jax_bytes(tmp_path, per_class, seed, smoke):
    got = loadgen.make_inputs(str(tmp_path / "port"), loadgen.DEFAULT_FAMILY_PMF,
                              per_class=per_class, seed=seed, smoke=smoke)
    want = jax_loadgen.make_inputs(str(tmp_path / "jax"), jax_loadgen.DEFAULT_FAMILY_PMF,
                                   per_class=per_class, seed=seed, smoke=smoke)
    assert set(got) == set(loadgen.QOS_CLASSES) == set(want)
    for qos in got:
        assert len(got[qos]) == per_class
        assert [os.path.basename(p) for p in got[qos]] == \
            [os.path.basename(p) for p in want[qos]]
        assert [_sha(p) for p in got[qos]] == [_sha(p) for p in want[qos]]


def _env(tmp_path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith(("CCT_PROF", "CCT_TRACE"))}
    return {**env, "CCT_SERVE_DRAIN_S": "10", **extra}


def _loadgen(tmp_path, env, *extra) -> tuple[subprocess.CompletedProcess, str]:
    out = str(tmp_path / "lg.json")
    proc = subprocess.run(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.utils.loadgen",
         "--workdir", str(tmp_path / "lg"), "--smoke", "--out", out, *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=420)
    return proc, out


def _check_artifact(out: str, fleet: bool) -> dict:
    with open(out) as fh:
        doc = json.load(fh)
    with open(os.path.join(REPO, "BENCH_LOADGEN_r12.json")) as fh:
        reference = json.load(fh)
    assert set(doc) == set(reference) - (set() if fleet else FLEET_KEYS)
    assert doc["levels"] and len(doc["levels"]) == 3
    assert all(lv["aggregate"]["lost"] == 0 for lv in doc["levels"])
    assert doc["knee"]["max_throughput_jobs_per_s"] > 0
    # a router has no SLO of its own (null, as in the committed fleet run):
    # its members' snapshots carry the classes
    slos = ([nd["slo"] for nd in doc["nodes_final"].values()] if fleet
            else [doc["slo"]])
    assert doc["slo"] is None or not fleet
    for slo in slos:
        assert set(slo["classes"]) == set(loadgen.QOS_CLASSES)
    assert doc["autotune"] is None
    assert (doc["config"]["workers"] > 0) is fleet
    assert doc["attribution"]["nodes"]
    # a warm daemon builds no kernel library past the preflight
    assert all(lv["recompiles_total"] == doc["preflight_recompiles_total"]
               for lv in doc["levels"])
    rc = subprocess.run(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.utils.perf_gate", "--fresh", out,
         "--baseline", out], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert rc.returncode == 0, rc.stderr
    assert json.loads(rc.stdout)["ok"] is True
    return doc


def test_smoke_against_a_cpu_daemon(tmp_path):
    env = _env(tmp_path, CCT_PROF="1", CCT_PROF_HZ="199",
               CCT_PROF_DIR=str(tmp_path / "profs"))
    proc, out = _loadgen(tmp_path, env, "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = _check_artifact(out, fleet=False)
    assert all(lv["nodes"] is None for lv in doc["levels"])
    assert "spawned daemon pid" in proc.stdout and "knee=" in proc.stdout


def test_smoke_sweep_through_one_and_two_worker_fleets(tmp_path):
    """``--sweep_workers 1,2``: a ``route --spawn N`` fleet per count, each
    run an artifact of the committed fleet run's shape, combined into one
    artifact of the committed sweep's (``BENCH_LOADGEN_r09.json``) shape."""
    env = _env(tmp_path, CCT_PROF="1", CCT_PROF_HZ="199",
               CCT_PROF_DIR=str(tmp_path / "profs"))
    proc, out = _loadgen(tmp_path, env, "--sweep_workers", "1,2", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out) as fh:
        sweep = json.load(fh)
    with open(os.path.join(REPO, "BENCH_LOADGEN_r09.json")) as fh:
        assert set(sweep) == set(json.load(fh))
    assert sorted(sweep["runs"]) == sorted(sweep["scaling"]) == ["1", "2"]
    assert sweep["scaling"]["1"]["speedup_vs_1_worker"] == 1.0
    for n in (1, 2):
        doc = _check_artifact(str(tmp_path / "lg" / f"sweep_w{n}.json"), fleet=True)
        assert doc["fleet"]["size"] == n and sweep["runs"][str(n)] == doc
        routed = sum(st["jobs_routed"] for lv in doc["levels"]
                     for st in lv["nodes"].values())
        assert routed == sum(lv["aggregate"]["submitted"] for lv in doc["levels"])
    gate = subprocess.run(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.utils.perf_gate", "--fresh", out,
         "--baseline", out], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert gate.returncode == 0, gate.stderr
    assert {c["name"].split(":")[0] for c in json.loads(gate.stdout)["checks"]} == {"1", "2"}


def test_the_card_is_the_default_and_nothing_falls_back(tmp_path):
    env = _env(tmp_path, CUDA_VISIBLE_DEVICES="")
    proc, out = _loadgen(tmp_path, env)
    assert proc.returncode != 0
    assert "the spawned child exited" in proc.stderr
    assert "CUDA is not available" in proc.stderr
    assert not os.path.exists(out)
