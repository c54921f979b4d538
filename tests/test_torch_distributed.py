"""``parallel/distributed.py`` of the port: a two-process rendezvous (CPU).

The port of ``tests/test_distributed.py``.  Two real processes of ``python
-m consensuscruncher_tpu_torch.parallel.distributed --device cpu
--dist_backend gloo --local-devices 2`` join one ``torch.distributed``
group over ``tcp://127.0.0.1``, each votes its share of the global batch
on its two CPU shards (``full_pipeline_step``) and the stats are summed
over the processes.  Both must report the stats of the JAX package's
``full_pipeline_step`` over a 4-device mesh of the same global batch, and
their stream-wire shards must match the oracle.  Every process has a
deadline, so a lost rendezvous fails the test rather than hanging it.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from consensuscruncher_tpu.parallel.mesh import full_pipeline_step, make_mesh
from consensuscruncher_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(port: int, num: int, pid: int, batch: int) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.parallel.distributed",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(num),
         "--process-id", str(pid), "--local-devices", "2", "--batch-per-process", str(batch),
         "--device", "cpu", "--dist_backend", "gloo"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _reference_batch(num_processes, batch_per_process, fam=4, length=32, seed=7):
    """The JAX package's dryrun draws, in its order
    (``consensuscruncher_tpu/parallel/distributed.run_dryrun_process``)."""
    rng = np.random.default_rng(seed)
    total = batch_per_process * num_processes
    bases_a = rng.integers(0, 4, (total, fam, length)).astype(np.uint8)
    quals_a = rng.integers(20, 41, (total, fam, length)).astype(np.uint8)
    sizes_a = rng.integers(1, fam + 1, (total,)).astype(np.int32)
    bases_b = bases_a.copy()
    quals_b = rng.integers(20, 41, (total, fam, length)).astype(np.uint8)
    sizes_b = sizes_a.copy()
    sizes_b[::4] = 0
    return rng, (bases_a, quals_a, sizes_a, bases_b, quals_b, sizes_b)


def test_dryrun_batch_draws_as_the_reference():
    rng, batch = distributed.dryrun_batch(2, 8, 4, 32, 7)
    ref_rng, ref = _reference_batch(2, 8)
    for got, want in zip(batch, ref):
        np.testing.assert_array_equal(got, want)
    assert rng.integers(0, 1 << 30) == ref_rng.integers(0, 1 << 30)


def test_two_process_gloo_rendezvous_equals_jax_step():
    port = _free_port()
    batch = 8
    procs = [_launch(port, 2, pid, batch) for pid in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=DEADLINE_S)
            assert p.returncode == 0, f"worker failed:\nstdout={out}\nstderr={err[-2000:]}"
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        # never leak a rendezvous-blocked sibling when one process fails
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    _rng, ref = _reference_batch(2, batch)
    want = np.asarray(full_pipeline_step(make_mesh(4))(*ref)[-1]).tolist()
    for r in results:
        assert (r["n_processes"], r["n_global_devices"], r["backend"]) == (2, 4, "gloo")
        assert r["stream_wire_ok"] is True
        assert r["stream_families"] == 24  # 6 per global shard
        assert [r["families"], r["duplexes"], r["n_count"], r["q_sum"]] == want
        assert r["families"] == r["expect_families"] == 2 * batch
        assert r["duplexes"] == r["expect_duplexes"]
    assert [r["process_id"] for r in results] == [0, 1]


def test_one_process_group_mesh_feed_and_reduce():
    """``initialize`` / ``global_mesh`` / ``feed_local`` /
    ``all_reduce_stats`` in a group of one (gloo, this process)."""
    import pytest
    import torch
    import torch.distributed as dist

    distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0, "gloo")
    try:
        mesh = distributed.global_mesh(torch.device("cpu"), 2)
        assert (mesh.world_size, mesh.rank, mesh.size, mesh.local.size) == (1, 0, 2, 2)
        a = np.arange(12).reshape(4, 3)
        (fed,) = distributed.feed_local(mesh, a)
        np.testing.assert_array_equal(fed, a)
        with pytest.raises(ValueError, match="does not split"):
            distributed.feed_local(mesh, a[:3])
        total = distributed.all_reduce_stats(torch.tensor([1, 2, 3, 4], dtype=torch.int32))
        assert total.dtype == torch.int64 and total.tolist() == [1, 2, 3, 4]
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="unknown backend"):
        distributed.initialize("127.0.0.1:1", 1, 0, "mpi")
