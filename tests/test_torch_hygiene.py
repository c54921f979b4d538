"""Boundaries of the port: no JAX, the card by default, no quiet fallback.

- importing the port and running its CLI imports neither ``jax`` nor any
  module of the JAX package (checked in a fresh interpreter), a staged run,
  a streaming run with QC and a run of the object paths (``--max_mismatch
  1 --wire dense``) alike;
- resolving the default device without CUDA raises instead of carrying on
  on the CPU, and so do the duplex op and the pipelined fused runner when
  no device is named;
- the vote wrappers (SSCS, with and without the QC rider, and fused
  duplex) never hand a CUDA tensor to the plain version: they launch the
  kernel or raise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from consensuscruncher_tpu_torch import device as device_mod
from consensuscruncher_tpu_torch.ops import consensus_vote, duplex

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


def test_cli_defaults_to_cuda(monkeypatch, tmp_path):
    from consensuscruncher_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["consensus", "-i", os.path.join(REPO, "test", "data", "sample.bam"),
              "-o", str(tmp_path)])
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
