"""The port's quality gate against the JAX package's ``tools/qc_gate.py`` (CPU).

The JAX gate is loaded from its path and run as it stands.  Held: the
five gate cases of ``tests/test_qc.py`` (an honest re-run, an error
inversion, recall and rate drift, an empty SSCS output, the newest
baseline), each through both gates' ``gate`` and through both ``main``s,
give equal check lists, equal verdict documents and equal exit codes;
so do the committed ``BENCH_QC_r13.json`` and ``BENCH_QC_r17.json``
against each other, with and without ``--smoke``; and both gates pick
the same default baseline.
"""

import contextlib
import importlib.util
import io
import json
import os

import pytest

from consensuscruncher_tpu_torch.utils import qc_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_gate = _jax_tool("qc_gate")


def _artifact(err_sscs=0.0, err_dcs=0.0, recall=0.95, fp_mb=0.0,
              sscs_written=100, sscs_yield=0.8):
    """``tests/test_qc.py``'s artifact."""
    return {
        "version": 1, "kind": "qc_accuracy",
        "qc": {
            "spectrum": {"1": 50, "2": 30, "3": 20},
            "yields": {"families": 120, "sscs_written": sscs_written},
            "rates": {"sscs_yield": sscs_yield, "singleton_rate": 0.1,
                      "rescue_rate": 0.5, "dropout_rate": 0.1,
                      "duplex_rate": 0.9, "dcs_yield": 0.8},
            "plane": {"disagree_rate": 0.004},
        },
        "accuracy": {"policies": {"default": {
            "per_base_error": {"raw": 0.005, "sscs": err_sscs,
                               "dcs": err_dcs},
            "variants": {
                "sscs": {"recall": recall, "fp_per_mb": fp_mb},
                "dcs": {"recall": recall, "fp_per_mb": fp_mb},
            },
        }}},
    }


TOLERANCES = dict(spectrum_tol=0.10, rate_tol=0.05, err_tol=0.5, err_floor=2e-4,
                  recall_tol=0.05, fp_tol_mb=200.0)

# (case, fresh, the checks that must fail)
CASES = [
    ("honest_rerun", _artifact(), set()),
    ("error_inversion", _artifact(err_sscs=0.02), {"default:error_ordering:sscs"}),
    ("recall_drift", _artifact(recall=0.5), {"default:variant_recall:sscs"}),
    ("rate_drift", _artifact(sscs_yield=0.5), {"rate:sscs_yield"}),
    ("empty_sscs", _artifact(sscs_written=0), {"sscs_written"}),
]


@pytest.mark.parametrize("case,fresh,failing", CASES, ids=[c[0] for c in CASES])
def test_gate_checks_equal_jax(case, fresh, failing):
    got = qc_gate.gate(fresh, _artifact(), **TOLERANCES)
    want = jax_gate.gate(fresh, _artifact(), **TOLERANCES)
    assert got == want and got
    assert failing <= {c["name"] for c in got if not c["ok"]}
    if not failing:
        assert all(c["ok"] for c in got)


def _main(tool, argv) -> tuple[int, dict | None, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool.main(argv)
    text = out.getvalue()
    return rc, (json.loads(text) if text.strip() else None), err.getvalue()


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("case,fresh,failing", CASES, ids=[c[0] for c in CASES])
def test_main_verdicts_equal_jax(tmp_path, case, fresh, failing, smoke):
    fresh_path, base_path = tmp_path / "fresh.json", tmp_path / "base.json"
    fresh_path.write_text(json.dumps(fresh))
    base_path.write_text(json.dumps(_artifact()))
    runs = []
    for tool, out in ((qc_gate, "port.json"), (jax_gate, "jax.json")):
        argv = ["--fresh", str(fresh_path), "--baseline", str(base_path),
                "--out", str(tmp_path / out)] + (["--smoke"] if smoke else [])
        runs.append(_main(tool, argv))
    (rc, verdict, err), (jrc, jverdict, jerr) = runs
    assert rc == jrc == (1 if failing else 0)
    assert verdict == jverdict
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert err == jerr


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("fresh,base", [("r17", "r13"), ("r13", "r17"), ("r17", "r17")])
def test_committed_artifacts_equal_jax(fresh, base, smoke):
    argv = ["--fresh", os.path.join(REPO, f"BENCH_QC_{fresh}.json"),
            "--baseline", os.path.join(REPO, f"BENCH_QC_{base}.json")]
    argv += ["--smoke"] if smoke else []
    assert _main(qc_gate, argv) == _main(jax_gate, argv)


def test_find_baseline_prefers_newest(tmp_path):
    for n in (3, 13, 7):
        (tmp_path / f"BENCH_QC_r{n}.json").write_text("{}")
    for tool in (qc_gate, jax_gate):
        got = tool.find_baseline(str(tmp_path))
        assert os.path.basename(got) == "BENCH_QC_r13.json"
        assert tool.find_baseline(str(tmp_path / "empty")) is None


def test_default_baseline_is_the_newest_committed_file():
    assert qc_gate.find_baseline() == jax_gate.find_baseline()
    assert os.path.basename(qc_gate.find_baseline()) == "BENCH_QC_r17.json"
    argv = ["--fresh", os.path.join(REPO, "BENCH_QC_r13.json"), "--smoke"]
    rc, verdict, _ = _main(qc_gate, argv)
    assert (rc, verdict) == _main(jax_gate, argv)[:2]
    assert verdict["baseline"] == "BENCH_QC_r17.json"


def test_unreadable_artifact_is_a_usage_error(tmp_path):
    argv = ["--fresh", str(tmp_path / "missing.json"), "--baseline",
            os.path.join(REPO, "BENCH_QC_r17.json")]
    rc, verdict, err = _main(qc_gate, argv)
    assert rc == 2 and verdict is None and err.startswith("qc_gate: cannot load artifacts")
    assert _main(jax_gate, argv)[:2] == (2, None)
