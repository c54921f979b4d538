"""``consensus --policy delegation|distilled`` end to end (CPU).

On ``test/data/sample.bam`` and on a degraded sample (the port's
``simulate_bam``: 400 fragments, seed 7, ``degraded_read_rate`` 0.5, the
rest at defaults; every read of ``sample.bam`` has quals 25-40, above the
delegation threshold, so only a degraded set tells delegation from
majority), the port's ``--device cpu`` run equals the JAX CLI's
``--backend xla_cpu`` run under the same policy:

- every BAM, record by record with tags;
- the stats sidecars, with only the ``backend`` line dropped (the
  ``policy`` key is in both);
- ``qc.json``, whole (its plane is the majority run's: the rider reads the
  member planes, not the policy's choice);
- the sscs manifest params (``policy`` present, since it is not the
  default).

Each JAX run is made once for the module.  Also: ``--wire dense`` and
``--pipeline streaming`` write the stream wire's staged records,
``--residency False`` the same BAMs; a majority ``--resume`` over a
delegation run re-runs its sscs stage; an unknown policy or a missing
checkpoint writes nothing.
"""

import hashlib
import json
import os

import pytest

from consensuscruncher_tpu.cli import main as jax_main
from consensuscruncher_tpu.utils.simulate import SimConfig as JaxSimConfig
from consensuscruncher_tpu.utils.simulate import simulate_bam as jax_simulate_bam
from consensuscruncher_tpu_torch.cli import main as torch_main
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")
POLICIES = ("delegation", "distilled")
DEGRADED = dict(n_fragments=400, seed=7, degraded_read_rate=0.5)


def _argv(bam, out, policy, *extra):
    return ["consensus", "-i", bam, "-o", str(out), "-n", "run", "--scorrect", "True",
            "--policy", policy, *extra]


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _files(base, ext):
    return sorted(os.path.relpath(os.path.join(root, f), base)
                  for root, _dirs, files in os.walk(base) for f in files if f.endswith(ext))


def _sha256s(base):
    out = {}
    for rel in _files(base, ".bam"):
        with open(os.path.join(base, rel), "rb") as fh:
            out[rel] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _same_records(base, other):
    bams = _files(base, ".bam")
    assert bams == _files(other, ".bam") and len(bams) == 11
    for rel in bams:
        assert _records(os.path.join(base, rel)) == _records(os.path.join(other, rel)), rel


def _sidecar(path):
    """A stats sidecar without its backend line (the port's names its
    device, the JAX package's its backend)."""
    if path.endswith(".json"):
        with open(path) as fh:
            doc = json.load(fh)
    else:
        with open(path) as fh:
            doc = {ln.split(":")[0]: ln for ln in fh}
    return {k: v for k, v in doc.items() if k not in ("backend", "jax_backend")}


def _json(path):
    with open(path) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """``sample.bam`` and the degraded sample (the port's simulator; the
    JAX simulator writes the same bytes)."""
    out = tmp_path_factory.mktemp("policy_inputs")
    degraded = str(out / "degraded.bam")
    simulate_bam(degraded, SimConfig(**DEGRADED))
    jax_simulate_bam(str(out / "degraded_jax.bam"), JaxSimConfig(**DEGRADED))
    with open(degraded, "rb") as a, open(out / "degraded_jax.bam", "rb") as b:
        assert a.read() == b.read()
    return {"sample": SAMPLE, "degraded": degraded}


@pytest.fixture(scope="module")
def jax_runs(inputs, tmp_path_factory):
    """One JAX CLI run per (input, policy), staged, stream wire."""
    out = tmp_path_factory.mktemp("policy_jax")
    runs = {}
    for name, bam in inputs.items():
        for policy in POLICIES:
            jax_main(_argv(bam, out / name / policy, policy, "--backend", "xla_cpu"))
            runs[name, policy] = out / name / policy / "run"
    return runs


@pytest.fixture(scope="module")
def port_runs(inputs, tmp_path_factory):
    """The port's staged stream-wire run per (input, policy) on the CPU."""
    out = tmp_path_factory.mktemp("policy_port")
    runs = {}
    for name, bam in inputs.items():
        for policy in POLICIES:
            res = torch_main(_argv(bam, out / name / policy, policy, "--device", "cpu"))
            assert res["pipeline"] == "staged"
            runs[name, policy] = out / name / policy / "run"
    return runs


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["sample", "degraded"])
def test_cli_matches_jax(jax_runs, port_runs, name, policy):
    base, jbase = port_runs[name, policy], jax_runs[name, policy]
    _same_records(str(base), str(jbase))
    sidecars = _files(str(jbase), ("_stats.txt", "_stats.json"))
    assert sidecars == _files(str(base), ("_stats.txt", "_stats.json")) and len(sidecars) == 6
    for rel in sidecars:
        assert _sidecar(os.path.join(base, rel)) == _sidecar(os.path.join(jbase, rel)), rel
    assert _json(base / "sscs" / "run.sscs_stats.json")["policy"] == policy
    got, want = _json(base / "qc.json"), _json(jbase / "qc.json")
    assert got == want and got["policy"] == policy and got["plane"]["total_votes"] > 0
    params = _json(base / "manifest.json")["stages"]["sscs"]["params"]
    assert params == _json(jbase / "manifest.json")["stages"]["sscs"]["params"]
    assert params["policy"] == policy


def test_policies_differ_on_the_degraded_sample_only(inputs, port_runs, tmp_path):
    """On the degraded sample delegation's and distilled's SSCS BAMs differ
    from majority's and from each other, while qc.json's plane is
    majority's; on ``sample.bam`` (quals 25-40) delegation is majority."""
    sscs = "sscs/run.sscs.sorted.bam"
    for name in ("sample", "degraded"):
        torch_main(_argv(inputs[name], tmp_path / name, "majority", "--device", "cpu"))
        majority = tmp_path / name / "run"
        shas = {p: _sha256s(str(port_runs[name, p]))[sscs] for p in POLICIES}
        shas["majority"] = _sha256s(str(majority))[sscs]
        plane = _json(majority / "qc.json")["plane"]
        for policy in POLICIES:
            assert _json(port_runs[name, policy] / "qc.json")["plane"] == plane
        if name == "degraded":
            assert len(set(shas.values())) == 3
        else:
            assert shas["delegation"] == shas["majority"] != shas["distilled"]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["sample", "degraded"])
def test_dense_wire_and_streaming_write_the_same_records(inputs, port_runs, tmp_path, name,
                                                         policy):
    for extra in (["--wire", "dense"], ["--pipeline", "streaming", "--intermediate_taps",
                                        "True"]):
        out = tmp_path / extra[1]
        res = torch_main(_argv(inputs[name], out, policy, "--device", "cpu", *extra))
        assert res["pipeline"] == ("streaming" if "streaming" in extra else "staged")
        _same_records(str(out / "run"), str(port_runs[name, policy]))


@pytest.mark.parametrize("policy", POLICIES)
def test_residency_off_writes_the_same_bams(inputs, port_runs, tmp_path, policy):
    torch_main(_argv(inputs["degraded"], tmp_path, policy, "--device", "cpu",
                     "--residency", "False"))
    assert _sha256s(str(tmp_path / "run")) == _sha256s(str(port_runs["degraded", policy]))


def test_majority_resume_reruns_a_delegation_sscs(inputs, tmp_path, capsys):
    torch_main(_argv(inputs["degraded"], tmp_path, "delegation", "--device", "cpu"))
    base = tmp_path / "run"
    delegation = _sha256s(str(base))
    capsys.readouterr()
    torch_main(_argv(inputs["degraded"], tmp_path, "delegation", "--device", "cpu",
                     "--resume", "True"))
    assert "skipping sscs " in capsys.readouterr().out
    torch_main(_argv(inputs["degraded"], tmp_path, "majority", "--device", "cpu",
                     "--resume", "True"))
    assert "skipping sscs " not in capsys.readouterr().out
    params = _json(base / "manifest.json")["stages"]["sscs"]["params"]
    assert "policy" not in params
    assert "policy" not in _json(base / "sscs" / "run.sscs_stats.json")
    assert _sha256s(str(base))["sscs/run.sscs.sorted.bam"] != \
        delegation["sscs/run.sscs.sorted.bam"]


def test_unknown_policy_or_bad_checkpoint_writes_nothing(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="unknown vote policy 'bogus'"):
        torch_main(_argv(SAMPLE, tmp_path / "a", "bogus", "--device", "cpu"))
    assert not (tmp_path / "a").exists()
    monkeypatch.setenv("CCT_DISTILLED_CHECKPOINT", str(tmp_path / "missing.json"))
    with pytest.raises(FileNotFoundError):
        torch_main(_argv(SAMPLE, tmp_path / "b", "distilled", "--device", "cpu"))
    assert not (tmp_path / "b").exists()
