"""Boundaries of the port: no JAX, the card by default, no quiet fallback.

- importing the port and running its CLI imports neither ``jax`` nor any
  module of the JAX package (checked in a fresh interpreter), a staged run,
  a streaming run with QC, a run of the object paths (``--max_mismatch
  1 --wire dense``) and a ``--policy distilled`` run alike;
- resolving the default device without CUDA raises instead of carrying on
  on the CPU, and so do the duplex op and the pipelined fused runner when
  no device is named;
- the vote wrappers (SSCS, with and without the QC rider, and fused
  duplex) never hand a CUDA tensor to the plain version: they launch the
  kernel or raise;
- a default run (no ``--policy``) never enters the policy path, and a
  policy vote stays on its planes' device: run on ``meta`` tensors (which
  hold no data, so any copy to the host raises), every output is on that
  device and no op reads member planes on the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from consensuscruncher_tpu_torch import device as device_mod
from consensuscruncher_tpu_torch.ops import consensus_segment, consensus_vote, duplex
from consensuscruncher_tpu_torch.ops.packing import WIRES, encode_wire
from consensuscruncher_tpu_torch.policies import base as policy_base

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, sys
import consensuscruncher_tpu_torch
import consensuscruncher_tpu_torch.ops.consensus_segment
import consensuscruncher_tpu_torch.ops.residency
import consensuscruncher_tpu_torch.parallel.prefetch
from consensuscruncher_tpu_torch.cli import main
main(["consensus", "-i", sys.argv[1], "-o", sys.argv[2], "--device", "cpu", *sys.argv[3:]])
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m.startswith("jaxlib")
                        or m.startswith("consensuscruncher_tpu."))))
"""


def test_port_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, os.path.join(REPO, "test", "data", "sample.bam"),
         str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert (tmp_path / "sample" / "all_unique" / "sample.all.unique.dcs.bam").exists()


def test_streaming_run_with_qc_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CCT_QC"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, os.path.join(REPO, "test", "data", "sample.bam"),
         str(tmp_path), "--pipeline", "streaming"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    with open(tmp_path / "sample" / "qc.json") as fh:
        qc = json.load(fh)
    assert qc["pipeline"] == "streaming" and qc["plane"]["total_votes"] > 0


def test_object_paths_import_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, os.path.join(REPO, "test", "data", "sample_bcerr.bam"),
         str(tmp_path), "--max_mismatch", "1", "--wire", "dense"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    with open(tmp_path / "sample_bcerr" / "singleton" / "sample_bcerr.singleton_stats.json") as fh:
        assert json.load(fh)["max_mismatch"] == 1


def test_distilled_policy_run_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, os.path.join(REPO, "test", "data", "sample.bam"),
         str(tmp_path), "--policy", "distilled", "--wire", "dense"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    with open(tmp_path / "sample" / "sscs" / "sample.sscs_stats.json") as fh:
        assert json.load(fh)["policy"] == "distilled"


@pytest.mark.parametrize("extra", [[], ["--wire", "dense"], ["--pipeline", "streaming"]])
def test_default_run_never_enters_the_policy_path(tmp_path, monkeypatch, extra):
    """A run with no ``--policy`` votes through B1 only: the policy stream
    vote and every policy's ``family_vote_fn`` are never called, and no
    sidecar or manifest names a policy."""
    from consensuscruncher_tpu_torch.cli import main

    calls = {"b1": 0}

    def refuse(*a, **k):
        raise AssertionError("a default run entered the policy path")

    def counting(fn):
        def wrapped(*a, **k):
            calls["b1"] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(consensus_segment, "policy_stream_vote", refuse)
    monkeypatch.setattr(policy_base.VotePolicy, "family_vote_fn", refuse)
    monkeypatch.setattr(consensus_vote, "vote_wire", counting(consensus_vote.vote_wire))
    monkeypatch.setattr(consensus_vote, "vote_members", counting(consensus_vote.vote_members))
    main(["consensus", "-i", os.path.join(REPO, "test", "data", "sample.bam"),
          "-o", str(tmp_path), "--device", "cpu", *extra])
    assert calls["b1"] > 0
    base = tmp_path / "sample"
    with open(base / "sscs" / "sample.sscs_stats.json") as fh:
        assert "policy" not in json.load(fh)
    with open(base / "manifest.json") as fh:
        for entry in json.load(fh)["stages"].values():
            assert "policy" not in entry["params"]
    with open(base / "qc.json") as fh:
        assert json.load(fh)["policy"] == "majority"


class _HostReads(torch.overrides.TorchFunctionMode):
    """Records every torch op that takes a uint8 CPU tensor of two or more
    dimensions: member planes (the host's own checks read 1-D sizes, a
    codebook is 1-D, and the distilled head's float weights go to the
    device once)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in list(args) + list(kwargs.values()):
            if (isinstance(t, torch.Tensor) and t.device.type == "cpu" and t.dim() >= 2
                    and t.dtype == torch.uint8):
                self.seen.append(getattr(func, "__name__", str(func)))
        return func(*args, **kwargs)


@pytest.mark.parametrize("policy", ["delegation", "distilled"])
def test_policy_vote_stays_on_its_device(policy):
    rng = np.random.default_rng(0)
    sizes = np.array([2, 3, 0, 4], np.int32)
    bases = rng.integers(0, 4, (9, 32)).astype(np.uint8)
    quals = rng.choice(np.array([10, 20, 30, 40], np.uint8), (9, 32))
    dev = torch.device("meta")
    outs = []
    mode = _HostReads()
    for wire in WIRES:
        a, b = (torch.from_numpy(x) for x in encode_wire(wire, bases, quals))
        a = a.to(dev)
        b = b.to(dev) if wire == "raw" else b  # a codebook may stay on the host
        with mode:
            outs += consensus_segment.stream_vote(wire, a, b, sizes, out_len=24,
                                                  qc_lengths=torch.tensor([20, 24, 3, 10]),
                                                  policy=policy)
            outs.append(consensus_segment.stream_vote(wire, a, b, sizes, policy=policy))
    planes = torch.zeros((4, 5, 32), dtype=torch.uint8, device=dev)
    with mode:
        outs += consensus_vote.consensus_batch(planes, planes, sizes, qc=True, policy=policy)
        outs += consensus_vote.duplex_batch(planes, planes, sizes, planes, planes, sizes,
                                            policy=policy)
    assert len(outs) == 4 * 3 + 3 + 6
    assert all(o.device == dev for o in outs)
    assert mode.seen == []


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mod.resolve_device("cuda")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_duplex_op_defaults_to_cuda(monkeypatch):
    planes = [np.zeros((2, 8), np.uint8)] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        duplex.duplex_batch_host(*planes)
    out_b, out_q = duplex.duplex_batch_host(*planes, device="cpu")
    assert (out_b == 0).all() and (out_q == 0).all()


@pytest.mark.parametrize("policy", [[], ["--policy", "distilled"]])
def test_cli_defaults_to_cuda(monkeypatch, tmp_path, policy):
    from consensuscruncher_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["consensus", "-i", os.path.join(REPO, "test", "data", "sample.bam"),
              "-o", str(tmp_path), *policy])
    assert not (tmp_path / "sample").exists()


class _CudaLike:
    """Stands in for a CUDA tensor (this host has no card): the wrapper must
    route it to the kernel launch, never to the plain version."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self.t, name)


def test_vote_wrapper_on_cuda_tensor_never_runs_plain(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("plain vote reached for a CUDA tensor")

    def launch(*a, **k):
        raise RuntimeError("kernel launch reached")

    monkeypatch.setattr(consensus_vote, "vote_members_plain", plain)
    monkeypatch.setattr(consensus_vote, "unpack_wire", plain)
    monkeypatch.setattr(consensus_vote, "_prepare", launch)
    planes = _CudaLike(torch.zeros((4, 32), dtype=torch.uint8))
    sizes = torch.tensor([2, 2], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="kernel launch reached"):
        consensus_vote.vote_members(planes, planes, sizes)
    for wire, book in (("raw", planes), ("pack6", torch.arange(16, dtype=torch.uint8)),
                       ("pack4", torch.arange(4, dtype=torch.uint8))):
        with pytest.raises(RuntimeError, match="kernel launch reached"):
            consensus_vote.vote_wire(wire, planes, book, sizes)
        with pytest.raises(RuntimeError, match="kernel launch reached"):
            consensus_vote.duplex_wire(wire, planes, book, torch.tensor([1, 1, 1, 1]))


def test_rider_on_cuda_tensor_never_runs_plain(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("plain vote reached for a CUDA tensor")

    def launch(*a, **k):
        assert k["qc_lengths"] is not None  # the rider rides the launch
        raise RuntimeError("kernel launch reached")

    monkeypatch.setattr(consensus_vote, "vote_members_plain", plain)
    monkeypatch.setattr(consensus_vote, "vote_wire_plain", plain)
    monkeypatch.setattr(consensus_vote, "_prepare", launch)
    planes = _CudaLike(torch.zeros((4, 32), dtype=torch.uint8))
    for wire, book in (("raw", planes), ("pack8", torch.arange(16, dtype=torch.uint8)),
                       ("pack6", torch.arange(16, dtype=torch.uint8)),
                       ("pack4", torch.arange(4, dtype=torch.uint8))):
        with pytest.raises(RuntimeError, match="kernel launch reached"):
            consensus_vote.vote_wire(wire, planes, book, torch.tensor([2, 2]),
                                     qc_lengths=torch.tensor([20, 24]))


def test_kernel_launch_refuses_cpu_planes():
    planes = torch.zeros((4, 32), dtype=torch.uint8)
    sizes, starts = torch.tensor([2, 2]), torch.tensor([0, 2])
    with pytest.raises(ValueError, match="CUDA planes"):
        consensus_vote.prepare_wire("raw", planes, planes, sizes,
                                    consensus_vote.ConsensusConfig(), 32)
    with pytest.raises(ValueError, match="CUDA planes"):
        consensus_vote._card_strand(planes, planes, sizes, starts)
    with pytest.raises(ValueError, match="CUDA rows"):
        consensus_vote.prepare_duplex_wire("pack4", planes, torch.arange(4, dtype=torch.uint8),
                                           torch.tensor([1, 1, 1, 1]))


def test_fused_wrapper_on_cuda_tensor_never_runs_plain(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("plain duplex vote reached for a CUDA tensor")

    def to_card(*a, **k):
        raise RuntimeError("kernel launch reached")

    monkeypatch.setattr(consensus_vote, "duplex_members_plain", plain)
    monkeypatch.setattr(consensus_vote, "_card_strand", to_card)
    planes = _CudaLike(torch.zeros((4, 32), dtype=torch.uint8))
    sizes = torch.tensor([2, 2], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="kernel launch reached"):
        consensus_vote.duplex_members(planes, planes, sizes, planes, planes, sizes)


def test_fused_wrapper_refuses_mixed_devices():
    planes = torch.zeros((4, 32), dtype=torch.uint8)
    sizes = torch.tensor([2, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="one device"):
        consensus_vote.duplex_members(planes, planes, sizes, _CudaLike(planes), planes,
                                      sizes)


def test_pipelined_runner_defaults_to_cuda(monkeypatch):
    from consensuscruncher_tpu_torch.ops.consensus_segment import run_duplex_pipelined

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows = np.zeros((2, 8), np.uint8)
    args = (rows, rows + 30, np.ones(1, np.int32), np.ones(1, np.int32),
            np.array([30, 30, 30, 30], np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_duplex_pipelined(*args)
    out = run_duplex_pipelined(*args, device="cpu")
    assert out[6].tolist() == [1, 1, 0, 8 * 60]
