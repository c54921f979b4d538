"""Boundaries of the port: no JAX, the card by default, no quiet fallback.

- importing the port and running its CLI imports neither ``jax`` nor any
  module of the JAX package (checked in a fresh interpreter), a staged run,
  a streaming run with QC, a run of the object paths (``--max_mismatch
  1 --wire dense``) and a ``--policy distilled`` run alike, and a
  ``-c config.ini`` batch run with ``--host_workers 2`` and ``--profile``
  in the parent and in every worker (nor matplotlib there), a ``--devices
  2`` run, and both processes of a ``parallel.distributed`` dryrun;
- resolving the default device without CUDA raises instead of carrying on
  on the CPU, and so do the duplex op and the pipelined fused runner when
  no device is named;
- the vote wrappers (SSCS, with and without the QC rider, and fused
  duplex) never hand a CUDA tensor to the plain version: they launch the
  kernel or raise;
- a default run (no ``--policy``) never enters the policy path, and a
  policy vote stays on its planes' device: run on ``meta`` tensors (which
  hold no data, so any copy to the host raises), every output is on that
  device and no op reads member planes on the CPU;
- every module of the port imports without JAX (the serve daemon, the
  fleet router, result cache and canary, the obs core, and the quality
  and capacity tools too); a ``serve
  --device cpu`` daemon and a ``submit`` client import none of it;
  ``serve`` without a card exits before it binds;
- a ``route --spawn 2 --backend xla_cpu`` fleet (the router, its two
  workers and a ``submit`` through it) imports none of it either, and a
  router parent spawning on the card (faked here) builds the kernel
  library once into the fleet's build directory, hands that directory to
  every worker and opens no CUDA context;
- ``fastq2bam --bwa builtin --host_workers 2`` and each standalone stage
  entry (``python -m ...stages.<stage>``) import none of it either, and
  ``fastq2bam`` (on a host with, as the test pretends, a card) forks its
  align pool without ever opening a CUDA context.
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


# A spy for every Python process of a command: at exit it writes its argv
# and the forbidden modules it imported (JAX, the JAX package, matplotlib).
_SPY = """
import atexit, json, os, sys

def _dump():
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "jaxlib", "consensuscruncher_tpu", "matplotlib")
                 or m.startswith(("jax.", "jaxlib.", "consensuscruncher_tpu.", "matplotlib.")))
    with open(os.path.join(os.environ["CCT_SPY_DIR"], f"{os.getpid()}.json"), "w") as fh:
        json.dump({"argv": sys.argv, "bad": bad}, fh)

atexit.register(_dump)
"""


def test_whole_command_imports_no_jax_in_parent_or_workers(tmp_path):
    """``-c config.ini``, a two-sample batch, ``--host_workers 2`` and
    ``--profile`` in one command: neither the parent nor any of its four
    workers imports JAX, the JAX package or matplotlib (a
    ``sitecustomize`` spy on every process's path records each one's
    modules at exit)."""
    spy, dumps = tmp_path / "spy", tmp_path / "dumps"
    spy.mkdir()
    dumps.mkdir()
    (spy / "sitecustomize.py").write_text(_SPY)
    cfg = tmp_path / "run.ini"
    cfg.write_text("[consensus]\nbackend = xla_cpu\nscorrect = True\n[qc]\nenabled = True\n")
    inputs = []
    for name in ("sample.bam", "sample_adversarial.bam"):
        inputs.append(str(tmp_path / name))
        with open(os.path.join(REPO, "test", "data", name), "rb") as src:
            (tmp_path / name).write_bytes(src.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(spy), CCT_SPY_DIR=str(dumps))
    proc = subprocess.run(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "consensus", "-c", str(cfg),
         "-i", ",".join(inputs), "-o", str(tmp_path / "out"), "--host_workers", "2",
         "--profile", str(tmp_path / "prof")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    runs = [json.loads(p.read_text()) for p in dumps.iterdir()]
    workers = [r for r in runs if "--input_range" in r["argv"]]
    assert len(runs) == 5 and len(workers) == 4
    assert all(r["argv"][r["argv"].index("--device") + 1] == "cpu" for r in workers)
    assert [r["bad"] for r in runs] == [[]] * 5
    assert len(os.listdir(tmp_path / "prof")) == 1
    for name in ("sample", "sample_adversarial"):
        with open(tmp_path / "out" / name / "qc.json") as fh:
            assert json.load(fh)["pipeline"] == "host_sharded[2]"
        assert (tmp_path / "out" / name / "plots" / f"{name}.stage_times.png").exists()


def test_devices_run_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, os.path.join(REPO, "test", "data", "sample.bam"),
         str(tmp_path), "--devices", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    with open(tmp_path / "sample" / "qc.json") as fh:
        assert json.load(fh)["plane"] is None  # the mesh ran: it arms no rider


def test_distributed_workers_import_no_jax(tmp_path):
    """Both processes of a two-process ``parallel.distributed`` dryrun
    (gloo, CPU shards) import no JAX and nothing of the JAX package (the
    ``sitecustomize`` spy records each one's modules at exit)."""
    import socket

    spy, dumps = tmp_path / "spy", tmp_path / "dumps"
    spy.mkdir()
    dumps.mkdir()
    (spy / "sitecustomize.py").write_text(_SPY)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(spy), CCT_SPY_DIR=str(dumps))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.parallel.distributed",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(i),
         "--device", "cpu", "--dist_backend", "gloo"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            assert json.loads(out.strip().splitlines()[-1])["stream_wire_ok"] is True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    runs = [json.loads(p.read_text()) for p in dumps.iterdir()]
    assert len(runs) == 2 and [r["bad"] for r in runs] == [[], []]


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


_ALL_MODULES = """
import json, pkgutil, sys, importlib
import consensuscruncher_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
               if not m.name.endswith("__main__"))
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names,
                  "bad": sorted(m for m in sys.modules
                                if m in ("jax", "jaxlib", "consensuscruncher_tpu", "tools")
                                or m.startswith(("jax.", "jaxlib.", "consensuscruncher_tpu.",
                                                 "tools.")))}))
"""


def test_every_module_imports_no_jax():
    """Every module of the port — the serve daemon, the obs core and its
    readers, the sanitizers, the model checker, the card probe, the
    quality and capacity tools (the gates, the accuracy harness, the load
    generator) and the soak tools (the soak, the trace checker, the chaos
    conductor) included —
    imports, in a fresh interpreter, without JAX, the JAX package or the
    reference's ``tools``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _ALL_MODULES], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["bad"] == []
    for name in ("serve.scheduler", "serve.server", "serve.journal", "serve.client",
                 "serve.supervisor", "serve.warmup", "serve.wire", "serve.router",
                 "serve.result_cache", "serve.canary", "obs.trace", "obs.flight",
                 "obs.slo", "obs.history", "obs.prof", "utils.sanitize",
                 "utils.backend_probe", "utils.netchaos", "utils.faults", "obs.critpath",
                 "obs.top", "utils.interleave", "utils.model_check", "utils.qc_gate",
                 "utils.accuracy_harness", "utils.perf_gate", "utils.loadgen",
                 "utils.serve_soak", "utils.trace_check", "utils.chaos_conductor"):
        assert f"consensuscruncher_tpu_torch.{name}" in doc["modules"]


def test_serve_without_a_card_exits_before_binding(tmp_path):
    """``serve`` with no ``--device cpu`` on a box with no CUDA exits with
    ``resolve_device``'s message, and its socket never exists."""
    sock = tmp_path / "d.sock"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "serve", "--socket",
         str(sock), "--journal", str(tmp_path / "j.wal")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available; pass device='cpu' (CLI: --device cpu)" in proc.stderr
    assert not sock.exists() and not (tmp_path / "j.wal").exists()


def test_serve_and_submit_import_no_jax(tmp_path):
    """A ``serve --device cpu`` daemon and a ``submit`` client, each a
    process of its own: the served job holds the goldens, and neither
    process imports JAX or the JAX package (the ``sitecustomize`` spy)."""
    import signal
    import time

    spy, dumps = tmp_path / "spy", tmp_path / "dumps"
    spy.mkdir()
    dumps.mkdir()
    (spy / "sitecustomize.py").write_text(_SPY)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(spy), CCT_SPY_DIR=str(dumps))
    sock = tmp_path / "d.sock"
    daemon = subprocess.Popen(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "serve", "--socket",
         str(sock), "--device", "cpu", "--journal", str(tmp_path / "j.wal"), "--gang_size", "2",
         "--warmup_shapes", "8x4x128"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while not sock.exists():
            assert daemon.poll() is None, daemon.communicate()[1][-2000:]
            assert time.monotonic() < deadline
            time.sleep(0.1)
        sub = subprocess.run(
            [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "submit", "--socket",
             str(sock), "-i", os.path.join(REPO, "test", "data", "sample.bam"), "-o",
             str(tmp_path / "out"), "-n", "golden"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert sub.returncode == 0, sub.stderr
        assert "done in" in sub.stdout
    finally:
        daemon.send_signal(signal.SIGTERM)
        out, err = daemon.communicate(timeout=120)
    assert daemon.returncode == 0, err[-2000:]
    assert "serve: warmed 1/1 bucket shapes on cpu" in out and "shutdown complete" in out
    runs = [json.loads(p.read_text()) for p in dumps.iterdir()]
    assert len(runs) == 2 and [r["bad"] for r in runs] == [[], []]
    from consensuscruncher_tpu_torch.utils.digest import golden_mismatches

    with open(os.path.join(REPO, "test", "golden.json")) as fh:
        golden = json.load(fh)["consensus"]
    assert golden_mismatches(str(tmp_path / "out" / "golden"), golden) == []


def test_route_fleet_imports_no_jax(tmp_path):
    """``route --spawn 2 --backend xla_cpu`` and a ``submit`` through it,
    each process spied on: the router, both workers and the client import
    no JAX and no JAX package; the job holds the goldens."""
    import signal
    import time

    spy, dumps = tmp_path / "spy", tmp_path / "dumps"
    spy.mkdir()
    dumps.mkdir()
    (spy / "sitecustomize.py").write_text(_SPY)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(spy), CCT_SPY_DIR=str(dumps))
    sock = tmp_path / "r.sock"
    router = subprocess.Popen(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "route", "--spawn", "2",
         "--backend", "xla_cpu", "--workdir", str(tmp_path / "fleet"), "--socket", str(sock),
         "--warmup_shapes", "8x4x128"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 180
        while not sock.exists():
            assert router.poll() is None, router.communicate()[1][-2000:]
            assert time.monotonic() < deadline
            time.sleep(0.1)
        sub = subprocess.run(
            [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "submit", "--socket",
             str(sock), "-i", os.path.join(REPO, "test", "data", "sample.bam"), "-o",
             str(tmp_path / "out"), "-n", "golden"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert sub.returncode == 0, sub.stderr
    finally:
        router.send_signal(signal.SIGTERM)
        out, err = router.communicate(timeout=180)
    assert router.returncode == 0, err[-2000:]
    assert "route: shutdown complete" in out and out.count("serve: shutdown complete") == 2
    runs = [json.loads(p.read_text()) for p in dumps.iterdir()]
    commands = ("route", "serve", "submit")
    assert sorted(next(a for a in r["argv"] if a in commands) for r in runs) == \
        ["route", "serve", "serve", "submit"]
    assert [r["bad"] for r in runs] == [[]] * 4
    from consensuscruncher_tpu_torch.utils.digest import golden_mismatches

    with open(os.path.join(REPO, "test", "golden.json")) as fh:
        golden = json.load(fh)["consensus"]
    assert golden_mismatches(str(tmp_path / "out" / "golden"), golden) == []


def test_card_router_builds_once_and_opens_no_context(tmp_path, monkeypatch):
    """A ``route --spawn 2`` parent on a host with (as this test pretends)
    two cards: one ``cuda_lib.build`` into ``<workdir>/build`` before any
    worker starts, every worker told ``--compile_cache <workdir>/build
    --device cuda``, worker *i* on card *i mod 2*, and no call that would
    open a CUDA context (on this CPU-only torch any such call raises).
    The workers' launch is recorded, not run."""
    from consensuscruncher_tpu_torch import cli as torch_cli
    from consensuscruncher_tpu_torch.ops import cuda_lib
    from consensuscruncher_tpu_torch.serve import router as router_mod
    from consensuscruncher_tpu_torch.serve import supervisor

    builds, launched = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", cuda_lib.BUILD_DIR)  # restored after
    monkeypatch.setattr(cuda_lib, "build", lambda name: builds.append((name, cuda_lib.BUILD_DIR)))

    class _Popen:
        def __init__(self, argv, env=None):
            launched.append((argv, env.get("CUDA_VISIBLE_DEVICES")))

    def run_supervised(cmd, spawn, max_restarts):
        spawn(cmd)
        with open(cmd[cmd.index("--socket") + 1], "w"):
            pass  # the worker's socket: up

    class _Stop(Exception):
        pass

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(torch_cli.subprocess, "Popen", _Popen)
    monkeypatch.setattr(supervisor, "run_supervised", run_supervised)
    monkeypatch.setattr(router_mod, "RouterServer", stop)
    workdir = tmp_path / "fleet"
    with pytest.raises(_Stop):
        torch_cli.main(["route", "--spawn", "2", "--workdir", str(workdir),
                        "--socket", str(tmp_path / "r.sock")])
    assert builds == [("consensus_vote", str(workdir / "build"))]
    assert len(launched) == 2
    for i, (argv, cards) in enumerate(sorted(launched, key=lambda x: x[0][-1])):
        assert cards == str(i)
    for argv, _cards in launched:
        assert argv[argv.index("--compile_cache") + 1] == str(workdir / "build")
        assert argv[argv.index("--device") + 1] == "cuda"
    assert not torch.cuda.is_initialized()


def _spy_run(tmp_path, argv) -> list:
    """Run ``python -m <argv>`` with the ``sitecustomize`` spy; returns
    each Python process's record."""
    spy, dumps = tmp_path / "spy", tmp_path / "dumps"
    spy.mkdir(exist_ok=True)
    dumps.mkdir(exist_ok=True)
    (spy / "sitecustomize.py").write_text(_SPY)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(spy), CCT_SPY_DIR=str(dumps))
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "falling back to serial" not in proc.stderr
    return [json.loads(p.read_text()) for p in dumps.iterdir()]


@pytest.mark.parametrize("entry", ["fastq2bam", "extract_barcodes", "sscs_maker",
                                   "singleton_correction", "dcs_maker", "generate_plots"])
def test_fastq2bam_and_stage_entries_import_no_jax(tmp_path, entry):
    from consensuscruncher_tpu_torch.stages import sscs_maker
    from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_fastq_pairs

    sample = os.path.join(REPO, "test", "data", "sample.bam")
    pkg = "consensuscruncher_tpu_torch"
    out = tmp_path / "out"
    out.mkdir()
    if entry in ("fastq2bam", "extract_barcodes"):
        r1, r2, fa = simulate_fastq_pairs(str(tmp_path / "sim"), SimConfig(
            n_fragments=80, ref_len=60_000, seed=3))
        argv = ([f"{pkg}.cli", "fastq2bam", "-f1", r1, "-f2", r2, "-o", str(out), "-n", "s",
                 "-r", fa, "--bwa", "builtin", "--bpattern", "NNNNNNT", "--host_workers", "2"]
                if entry == "fastq2bam" else
                [f"{pkg}.stages.extract_barcodes", "--read1", r1, "--read2", r2,
                 "--outfile", str(out / "s"), "--bpattern", "NNNNNNT"])
        want = out / ("bamfiles/s.sorted.bam.bai" if entry == "fastq2bam" else "s_r2.fastq.gz")
    elif entry == "sscs_maker":
        argv = [f"{pkg}.stages.sscs_maker", "--infile", sample, "--outfile", str(out / "x"),
                "--device", "cpu"]
        want = out / "x.sscs.sorted.bam"
    elif entry == "generate_plots":
        sscs_maker.run_sscs(sample, str(tmp_path / "x"), torch.device("cpu"))
        argv = [f"{pkg}.stages.generate_plots", "--families", str(tmp_path / "x.read_families.txt"),
                "--stats", str(tmp_path / "x.sscs_stats.json"), "--outdir", str(out)]
        want = out / "read_recovery.png"
    else:
        sscs_maker.run_sscs(sample, str(tmp_path / "x"), torch.device("cpu"))
        sscs = str(tmp_path / "x.sscs.sorted.bam")
        argv = ([f"{pkg}.stages.dcs_maker", "--infile", sscs] if entry == "dcs_maker" else
                [f"{pkg}.stages.singleton_correction", "--bamfile", sscs,
                 "--singleton", str(tmp_path / "x.singleton.sorted.bam"), "--max-mismatch", "1"])
        argv += ["--outfile", str(out / "y"), "--device", "cpu"]
        want = out / ("y.dcs.sorted.bam" if entry == "dcs_maker" else "y.sscs.rescue.sorted.bam")
    runs = _spy_run(tmp_path, argv)
    assert len(runs) == 1 and runs[0]["bad"] == []
    assert want.exists()


def test_fastq2bam_forks_its_pool_and_opens_no_context(tmp_path, monkeypatch, capfd):
    """``fastq2bam --host_workers 2`` on a host with (as this test
    pretends) two cards: the align pool forks (no serial fallback), and
    nothing asks torch for a CUDA context (on this CPU-only torch any such
    call raises; ``_lazy_init`` is also made to record itself)."""
    from consensuscruncher_tpu_torch import cli as torch_cli
    from consensuscruncher_tpu_torch.stages import align
    from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_fastq_pairs

    r1, r2, fa = simulate_fastq_pairs(str(tmp_path / "sim"), SimConfig(
        n_fragments=150, ref_len=80_000, seed=4))
    inits, pools = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "_lazy_init", lambda: inits.append(1))
    start_pool = align._start_pool

    def spy_pool(*args):
        pool = start_pool(*args)
        pools.append(pool)
        return pool

    monkeypatch.setattr(align, "_start_pool", spy_pool)
    res = torch_cli.main(["fastq2bam", "-f1", r1, "-f2", r2, "-o", str(tmp_path / "o"),
                          "-n", "s", "-r", fa, "--bwa", "builtin", "--bpattern", "NNNNNNT",
                          "--host_workers", "2"])
    assert os.path.exists(res["bam"] + ".bai")
    assert len(pools) == 1 and pools[0] is not None
    assert "falling back to serial" not in capfd.readouterr().err
    assert inits == [] and not torch.cuda.is_initialized()
