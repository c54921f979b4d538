"""The port's truth-set accuracy harness against the JAX package's
``tools/accuracy_harness.py`` (CPU).

The JAX tool is loaded from its path and run as it stands (``--backend
xla_cpu``, JAX on the CPU); the port's runs with ``--device cpu``.  Held:
at 60 fragments, ``--repeats 1``, ``--degraded_rate 0.5`` and all three
policies, both artifacts have equal ``accuracy`` and ``qc`` sections (rates
are ratios of integer counts, so exactly), honest and under ``--corrupt
0.02``; the artifact's shape; ``_read_level``, ``_score_reads`` (with and
without the corrupt control's rng), ``_variant_sites`` and
``_score_variants`` give equal results on seeded inputs; and the card is
the default: without CUDA the harness raises before it writes anything,
and ``--backend`` reads as the port's CLI reads it.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from consensuscruncher_tpu_torch.utils import accuracy_harness as harness
from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

spec = importlib.util.spec_from_file_location(
    "reference_accuracy_harness", os.path.join(REPO, "tools", "accuracy_harness.py"))
jax_harness = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax_harness)

CONFIG = ["--fragments", "60", "--repeats", "1", "--degraded_rate", "0.5",
          "--policies", "majority,delegation,distilled"]


def _run(tool, argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert tool.main(argv) == 0
    return json.loads(out.getvalue()[out.getvalue().index("\n{") + 1:])


@pytest.mark.parametrize("corrupt", ["0", "0.02"])
def test_artifact_equals_jax(tmp_path, monkeypatch, corrupt):
    monkeypatch.delenv("CCT_QC", raising=False)  # both tools set it per run
    monkeypatch.delenv("CCT_DISTILLED_CHECKPOINT", raising=False)
    argv = CONFIG + ["--corrupt", corrupt]
    want = _run(jax_harness, argv + ["--workdir", str(tmp_path / "jax"),
                                     "--backend", "xla_cpu"])
    got = _run(harness, argv + ["--workdir", str(tmp_path / "port"), "--device", "cpu",
                                "--out", str(tmp_path / "port.json")])
    assert got == json.loads((tmp_path / "port.json").read_text())
    assert set(got["accuracy"]["policies"]) == {"majority", "delegation", "distilled"}
    assert got["accuracy"] == want["accuracy"]
    assert got["qc"] == want["qc"] and got["qc"]["plane"]
    assert sorted(got) == sorted(want)
    assert got["corrupt"] == want["corrupt"] == float(corrupt)
    assert got["config"] == {**want["config"], "backend": "tpu", "device": "cpu"}
    assert set(got["stage_wall_s"]) == {"qc_off", "qc_on"}
    # the qc-off runs wrote no QC plane; every qc-on run did
    for run, qc in (("warm_off", False), ("off0", False), ("warm_on", True), ("on", True),
                    ("on_delegation", True), ("on_distilled", True)):
        assert (tmp_path / "port" / run / "acc" / "qc.json").exists() is qc, run
    errors = got["accuracy"]["policies"]["majority"]["per_base_error"]
    if corrupt == "0":
        assert errors["sscs"] < errors["raw"] and errors["dcs"] < errors["raw"]
    else:  # 2% of the consensus bases flipped at scoring
        assert errors["sscs"] > 0.01 and errors["dcs"] > 0.01


@pytest.fixture(scope="module")
def truth(tmp_path_factory):
    bam = str(tmp_path_factory.mktemp("truth") / "truth.bam")
    cfg = SimConfig(n_fragments=80, seed=11, degraded_read_rate=0.5)
    return bam, simulate_bam(bam, cfg), cfg


def _by_pos(truth, read_len):
    by_pos = {}
    for frag, (lo, mol) in truth.molecules.items():
        by_pos.setdefault(lo, []).append(frag)
        by_pos.setdefault(lo + len(mol) - read_len, []).append(frag)
    return by_pos


@pytest.mark.parametrize("rate", [0.0, 0.02, 0.3])
def test_scoring_functions_equal_jax(truth, rate):
    bam, sim, cfg = truth
    reads = harness._read_level(bam)
    assert reads == jax_harness._read_level(bam)
    by_pos = _by_pos(sim, cfg.read_len)
    rngs = [np.random.default_rng(5) if rate else None for _ in range(2)]
    got = harness._score_reads(reads, sim, by_pos, corrupt_rng=rngs[0], corrupt_rate=rate)
    want = jax_harness._score_reads(reads, sim, by_pos, corrupt_rng=rngs[1],
                                    corrupt_rate=rate)
    assert got == want and got[1] > 0
    for n_sites, seed in ((40, 8), (7, 1)):
        sites = harness._variant_sites(sim, n_sites, seed, cfg.read_len)
        assert sites == jax_harness._variant_sites(sim, n_sites, seed, cfg.read_len)
        assert harness._score_variants(sites, got[4]) == \
            jax_harness._score_variants(sites, want[4])


def test_the_card_is_the_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--backend", "tpu"], ["--device", "cuda"]):
        work, out = tmp_path / "w", tmp_path / "a.json"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            harness.main(CONFIG + ["--workdir", str(work), "--out", str(out), *extra])
        assert not work.exists() and not out.exists()


@pytest.mark.parametrize("backend,device,want", [
    ("tpu", "cpu", (["--device", "cpu"], "cpu")),
    ("xla_cpu", None, (["--device", "cpu"], "cpu")),
    ("cpu", None, (["--backend", "cpu"], None)),
    ("reference", None, (["--backend", "reference"], None)),
    ("cpu", "cpu", (["--device", "cpu"], "cpu")),
])
def test_backend_reads_as_the_cli_reads_it(monkeypatch, backend, device, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = type("Args", (), {"backend": backend, "device": device})()
    assert harness._target(args) == want


def test_unknown_backend_exits():
    args = type("Args", (), {"backend": "gpu", "device": None})()
    with pytest.raises(SystemExit, match="expected tpu, xla_cpu, cpu or reference"):
        harness._target(args)
