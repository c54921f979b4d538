"""The port's perf gate against the JAX package's ``tools/perf_gate.py`` (CPU).

The JAX gate is loaded from its path and run as it stands.  Held: the
perf-gate cases of ``tests/test_prof.py`` (an unchanged run, a throughput
regression with its verdict file, the tolerances and ``--smoke``'s strict
structural checks, an attribution-less baseline), and the committed
``BENCH_LOADGEN_r09.json`` (a fleet sweep) and ``r12.json`` (a fleet run)
against each other, give the JAX gate's verdict documents, messages and
exit codes.  The one departure: with no ``--baseline`` the port's gate
exits 2 naming the flag, where the JAX gate falls back to the newest
committed artifact (ROADMAP: "perf_gate takes no default baseline").
"""

import contextlib
import importlib.util
import io
import json
import os

import pytest

from consensuscruncher_tpu_torch.utils import perf_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

spec = importlib.util.spec_from_file_location("reference_perf_gate",
                                              os.path.join(REPO, "tools", "perf_gate.py"))
jax_gate = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax_gate)


def _artifact(tmp_path, name, tput=2.0, knee=2.0, lost=0, recs=(5, 5, 5),
              attr_shares=None, coverage=1.0):
    """``tests/test_prof.py``'s artifact."""
    doc = {
        "bench": "loadgen",
        "config": {"workers": 0},
        "levels": [
            {"aggregate": {"lost": lost, "shed_ratio": 0.0,
                           "throughput_jobs_per_s": tput},
             "recompiles_total": r} for r in recs],
        "knee": {"knee_offered_jobs_per_s": knee,
                 "max_throughput_jobs_per_s": tput,
                 "shed_knee_threshold": 0.05},
    }
    if attr_shares is not None:
        buckets = {k: attr_shares.get(k, 0.0) * 1000 for k in perf_gate.ATTR_BUCKETS}
        doc["attribution"] = {
            "nodes": {"n0": {"buckets_ms": buckets, "shares": attr_shares,
                             "wall_ms": 1000.0, "jobs": 3,
                             "coverage": coverage}},
            "fleet": {"buckets_ms": buckets, "shares": attr_shares,
                      "wall_ms": 1000.0, "jobs": 3, "coverage": coverage},
        }
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


SHARES = {"queue_ms": 0.2, "routing_ms": 0.0, "host_cpu_ms": 0.5,
          "device_dispatch_ms": 0.1, "deflate_ms": 0.1, "io_ms": 0.1}


def _main(tool, argv) -> tuple[int, dict | None, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool.main(argv)
    text = out.getvalue()
    return rc, (json.loads(text) if text.strip() else None), err.getvalue()


def _both(argv) -> tuple[int, dict]:
    got, want = _main(perf_gate, argv), _main(jax_gate, argv)
    assert got == want
    return got[:2]


def test_buckets_equal_jax():
    assert perf_gate.ATTR_BUCKETS == jax_gate.ATTR_BUCKETS


def test_passes_unchanged_run(tmp_path):
    base = _artifact(tmp_path, "base.json", attr_shares=SHARES)
    fresh = _artifact(tmp_path, "fresh.json", attr_shares=SHARES)
    rc, verdict = _both(["--fresh", fresh, "--baseline", base])
    assert rc == 0 and verdict["ok"] is True
    names = {c["name"] for c in verdict["checks"]}
    assert {"lost_jobs", "recompiles_flat", "attribution_coverage",
            "max_throughput_jobs_per_s"} <= names


def test_fails_regression_and_emits_verdict(tmp_path):
    base = _artifact(tmp_path, "base.json", tput=2.0)
    fresh = _artifact(tmp_path, "fresh.json", tput=1.0)  # -50% > 25% tol
    verdicts = []
    for tool, out in ((perf_gate, "port.json"), (jax_gate, "jax.json")):
        rc, _, _ = _main(tool, ["--fresh", fresh, "--baseline", base,
                                "--out", str(tmp_path / out)])
        assert rc == 1
        verdicts.append((tmp_path / out).read_text())
    assert verdicts[0] == verdicts[1]
    verdict = json.loads(verdicts[0])
    (bad,) = [c for c in verdict["checks"] if c["name"] == "max_throughput_jobs_per_s"]
    assert bad["ok"] is False and bad["got"] == 1.0


@pytest.mark.parametrize("fresh_kw,smoke,rc", [
    (dict(tput=1.6, attr_shares=dict(SHARES, queue_ms=0.3, host_cpu_ms=0.4)), False, 0),
    (dict(tput=0.8), False, 1),
    (dict(tput=0.8), True, 0),
    (dict(lost=1), True, 1),
    (dict(attr_shares=SHARES, coverage=0.5), True, 1),
    (dict(recs=(5, 6, 7)), True, 1),
    (dict(attr_shares=dict(SHARES, queue_ms=0.7, host_cpu_ms=0.0)), False, 1),
], ids=["near", "slow", "slow_smoke", "lossy_smoke", "uncovered_smoke", "recompiles",
        "attr_drift"])
def test_tolerances_and_smoke_strictness(tmp_path, fresh_kw, smoke, rc):
    base = _artifact(tmp_path, "base.json", tput=2.0, attr_shares=SHARES)
    fresh = _artifact(tmp_path, "fresh.json", **fresh_kw)
    got_rc, verdict = _both(["--fresh", fresh, "--baseline", base]
                            + (["--smoke"] if smoke else []))
    assert got_rc == rc and verdict["ok"] is (rc == 0)


def test_tolerates_attribution_less_baseline(tmp_path):
    base = _artifact(tmp_path, "base.json")                 # no attribution
    fresh = _artifact(tmp_path, "fresh.json", attr_shares=SHARES)
    rc, verdict = _both(["--fresh", fresh, "--baseline", base])
    assert rc == 0
    names = {c["name"] for c in verdict["checks"]}
    assert "attribution_coverage" in names
    assert not any(n.startswith("attr_share:") for n in names)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("fresh,base", [("r09", "r12"), ("r12", "r09"), ("r09", "r09"),
                                        ("r12", "r12")])
def test_committed_artifacts_equal_jax(fresh, base, smoke):
    argv = ["--fresh", os.path.join(REPO, f"BENCH_LOADGEN_{fresh}.json"),
            "--baseline", os.path.join(REPO, f"BENCH_LOADGEN_{base}.json")]
    rc, verdict = _both(argv + (["--smoke"] if smoke else []))
    assert verdict["checks"]
    if fresh == "r09":  # a sweep is judged run by run
        assert any(c["name"].startswith("1:") for c in verdict["checks"])


def test_no_baseline_exits_2_naming_the_flag(tmp_path):
    fresh = _artifact(tmp_path, "fresh.json")
    rc, verdict, err = _main(perf_gate, ["--fresh", fresh])
    assert rc == 2 and verdict is None
    assert "pass --baseline" in err
    # the JAX gate, by contrast, falls back to the newest committed artifact
    jrc, jverdict, _ = _main(jax_gate, ["--fresh", fresh])
    assert jrc in (0, 1) and jverdict["baseline"] == "BENCH_LOADGEN_r12.json"
    assert os.path.basename(perf_gate.find_baseline()) == "BENCH_LOADGEN_r12.json"


def test_find_baseline_prefers_newest(tmp_path):
    for n in (6, 12, 9):
        (tmp_path / f"BENCH_LOADGEN_r{n}.json").write_text("{}")
    for tool in (perf_gate, jax_gate):
        assert os.path.basename(tool.find_baseline(str(tmp_path))) == "BENCH_LOADGEN_r12.json"
        assert tool.find_baseline(str(tmp_path / "empty")) is None
