"""The port's ``utils/serve_soak.py`` against the JAX package's
``tools/serve_soak.py`` (CPU), and a live soak of the port's daemon.

The JAX tool is loaded from its path as it stands.  Held: ``job_spec``
equals the JAX tool's; ``check_golden`` gives the JAX tool's strings on a
whole served tree, on the tree with a text file and a BAM changed, and
with a file missing.  Live: ``--jobs 3 --seed 7 --kill-after 0.3 --device
cpu`` kills the supervised daemon while its jobs are in flight, and exits
0 with at least one job replayed from the journal (the restarted daemon's
metrics, read as the soak signals it to drain), a ``journal-replay``
flight dump beside it and every job's tree on the goldens; without a card
the default ``--device cuda`` daemon exits before its socket appears and
the soak fails naming the log's tail, no daemon serving.
"""

import contextlib
import glob
import importlib.util
import io
import json
import os
import shutil
import signal

import pytest
import torch

from consensuscruncher_tpu_torch.serve.client import ServeClient
from consensuscruncher_tpu_torch.utils import serve_soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = json.load(open(os.path.join(REPO, "test", "golden.json")))

spec = importlib.util.spec_from_file_location(
    "reference_serve_soak", os.path.join(REPO, "tools", "serve_soak.py"))
jax_soak = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax_soak)


def _soak(argv) -> tuple[int, str, str, list]:
    """``serve_soak.main(argv)`` with its output captured, no ``CCT_*``
    variable an earlier test of this process left behind (the daemon
    inherits them: ``CCT_TRACE_DIR`` alone moves its flight dumps out of
    the workdir), and each signal it sends: ``(signal, pid, the daemon's
    metrics read over its socket just before)``.  The daemons run torch on
    one thread, so the soak leaves the cores to the tests beside it."""
    out, err = io.StringIO(), io.StringIO()
    sock = os.path.join(argv[argv.index("--workdir") + 1], "soak.sock")
    sent = []
    real_kill = os.kill

    def kill(pid, sig):
        try:
            if sig in (signal.SIGKILL, signal.SIGTERM):
                sent.append((sig, pid, ServeClient(sock, retries=2).metrics()))
        finally:
            real_kill(pid, sig)

    with pytest.MonkeyPatch.context() as mp:
        for var in [k for k in os.environ if k.startswith("CCT_")]:
            mp.delenv(var)
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setattr(serve_soak.os, "kill", kill)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = serve_soak.main(argv)
    return rc, out.getvalue(), err.getvalue(), sent


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """One live soak on the CPU, the kill landing while jobs are in
    flight."""
    workdir = str(tmp_path_factory.mktemp("soak"))
    rc, out, err, sent = _soak(["--jobs", "3", "--seed", "7", "--kill-after", "0.3",
                                "--device", "cpu", "--workdir", workdir])
    return {"rc": rc, "out": out, "err": err, "workdir": workdir, "sent": sent}


def test_job_spec_equals_jax(tmp_path):
    out = str(tmp_path / "job0")
    assert serve_soak.job_spec(out) == jax_soak.job_spec(out)
    assert os.path.exists(serve_soak.job_spec(out)["input"])


def test_live_soak_replays_in_flight_jobs_to_the_goldens(live):
    assert live["rc"] == 0, live["err"][-3000:]
    assert "soak: OK — every accepted job byte-identical to golden" in live["out"]
    # one kill -9 of the first daemon, one SIGTERM of the restarted one
    (kill, killed, _), (term, drained, metrics) = live["sent"]
    assert (kill, term) == (signal.SIGKILL, signal.SIGTERM) and killed != drained
    replayed = metrics["cumulative"]["jobs_replayed"]
    assert replayed >= 1
    assert f"3 job(s) finished, {replayed} replayed from the journal" in live["out"]
    reasons = [json.load(open(p))["reason"]
               for p in glob.glob(os.path.join(live["workdir"], "flight-*.json"))]
    assert "journal-replay" in reasons
    assert f"soak: {len(reasons)} flight dump(s): " in live["out"]
    for i in range(3):
        base = os.path.join(live["workdir"], f"job{i}", "golden")
        assert serve_soak.check_golden(base, GOLDEN) == []


def test_check_golden_strings_equal_jax(live, tmp_path):
    tree = str(tmp_path / "golden")
    shutil.copytree(os.path.join(live["workdir"], "job0", "golden"), tree)
    assert serve_soak.check_golden(tree, GOLDEN) == jax_soak.check_golden(tree, GOLDEN) == []
    with open(os.path.join(tree, "sscs", "golden.sscs_stats.txt"), "a") as fh:
        fh.write("one more line\n")
    shutil.copy(os.path.join(tree, "sscs", "golden.sscs.sorted.bam"),
                os.path.join(tree, "dcs", "golden.dcs.sorted.bam"))
    changed = serve_soak.check_golden(tree, GOLDEN)
    assert changed == jax_soak.check_golden(tree, GOLDEN)
    assert [p.split(":")[0] for p in changed] == ["dcs/golden.dcs.sorted.bam",
                                                  "sscs/golden.sscs_stats.txt"]
    os.unlink(os.path.join(tree, "singleton", "golden.singleton_stats.json"))
    missing = serve_soak.check_golden(tree, GOLDEN)
    assert missing == jax_soak.check_golden(tree, GOLDEN)
    assert "missing singleton/golden.singleton_stats.json" in missing


def test_soak_without_a_card_fails_before_serving(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("holds the refusal on a host without a card")
    rc, out, err, sent = _soak(["--jobs", "3", "--seed", "7", "--workdir", str(tmp_path)])
    assert rc == 1
    assert "soak: FAIL the daemon exited 1 before serving" in err
    assert "CUDA is not available" in err
    assert "daemon serving" not in out and sent == []
    assert not os.path.exists(tmp_path / "soak.sock")
    assert not os.path.exists(tmp_path / "soak.journal")
