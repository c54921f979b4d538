"""Multi-process execution: the sharded pipeline step across processes.

Port of ``consensuscruncher_tpu/parallel/distributed.py`` onto
``torch.distributed``.  One process per host (or per group of cards) reads
its own share of the families and votes it on its local shards with the
single-process mesh code (``parallel.mesh``) unchanged; the only traffic
between processes is an ``all_reduce`` of the ``(4,)`` stats vector.

- :func:`initialize` joins the rendezvous (``init_process_group`` over
  ``tcp://<coordinator>``, with the world size and rank given: nothing
  on the machine tells a program of a cluster).
- :func:`global_mesh` is this process's local shards, with the world
  size and rank; :func:`feed_local` hands the local slice of the batch to
  them (no process ever holds the global batch).
- :func:`all_reduce_stats` sums a stats vector over the processes: on the
  card under ``nccl``; on the host under ``gloo``, which reduces the four
  integers there whatever the shards' device.

Verification without a cluster: ``python -m
consensuscruncher_tpu_torch.parallel.distributed --num-processes N
--process-id I --coordinator localhost:PORT`` runs one process of an
N-process rendezvous (``--device cpu --dist_backend gloo`` on a host with
no card; on one card, ``--device cuda --dist_backend gloo``, since NCCL
refuses two ranks on one GPU; across cards, ``nccl``, the default on the
card).  Each process prints its JSON result and exits 0 when the reduced
stats are the expected ones and its stream-wire shards match the oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from consensuscruncher_tpu_torch.core.consensus_cpu import consensus_maker
from consensuscruncher_tpu_torch.device import resolve_device
from consensuscruncher_tpu_torch.ops import consensus_vote
from consensuscruncher_tpu_torch.ops.consensus_vote import ConsensusConfig
from consensuscruncher_tpu_torch.parallel.mesh import (
    Mesh,
    full_pipeline_step,
    make_mesh,
    plan_member_shards,
    stack_member_shards,
)

BACKENDS = ("nccl", "gloo")
# bounds the rendezvous and every collective: a lost peer fails the process
TIMEOUT = timedelta(seconds=300)


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str = "gloo") -> None:
    """Join the rendezvous at ``coordinator`` (``host:port`` of process 0,
    or a ``tcp://`` URL) as rank ``process_id`` of ``num_processes``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
    url = coordinator if coordinator.startswith("tcp://") else f"tcp://{coordinator}"
    dist.init_process_group(backend=backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)


@dataclass(frozen=True)
class GlobalMesh:
    """This process's shards of a mesh spread over ``world_size``
    processes: global shard ``rank * local.size + j`` is ``local``'s
    shard ``j`` (process-major, as the JAX package's global device
    order)."""

    local: Mesh
    world_size: int
    rank: int

    @property
    def size(self) -> int:
        return self.local.size * self.world_size


def global_mesh(device: torch.device, local_devices: int) -> GlobalMesh:
    """The global mesh of an initialised process group, ``local_devices``
    shards per process: on the card, process ``r``'s shard ``j`` on visible
    card ``(r * local_devices + j) mod count`` (cards repeat when there are
    fewer than shards, as ``--devices`` lays them); on the CPU, CPU
    shards."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if device.type == "cuda":
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", (rank * local_devices + j) % count)
                for j in range(local_devices)]
    else:
        devs = [device] * local_devices
    return GlobalMesh(make_mesh(devices=devs), world, rank)


def feed_local(mesh: GlobalMesh, *host_arrays):
    """This process's slices of a global batch, as its local shards take
    them: each array's batch axis is the local fraction and must split
    evenly over the local shards."""
    out = tuple(np.ascontiguousarray(a) for a in host_arrays)
    for a in out:
        if a.shape[0] % mesh.local.size:
            raise ValueError(f"local batch axis {a.shape[0]} does not split over "
                             f"{mesh.local.size} local shards")
    return out


def all_reduce_stats(stats: torch.Tensor) -> torch.Tensor:
    """``stats`` summed over every process (int64): on its card under
    ``nccl``, on the host under ``gloo``."""
    if dist.get_backend() == "nccl":
        total = stats.to(torch.int64)
        with torch.cuda.device(total.device):
            dist.all_reduce(total)
        return total
    total = stats.to("cpu", torch.int64)
    dist.all_reduce(total)
    return total


def dryrun_batch(num_processes: int, batch_per_process: int, fam: int, length: int, seed: int):
    """The dryrun's global batch, every process drawing the same one:
    ``(rng, (bases_a, quals_a, sizes_a, bases_b, quals_b, sizes_b))``, in
    the JAX package's draw order (so the global batch and its stats are
    its), the generator left where the stream-wire draws go on."""
    rng = np.random.default_rng(seed)
    total = batch_per_process * num_processes
    bases_a = rng.integers(0, 4, (total, fam, length)).astype(np.uint8)
    quals_a = rng.integers(20, 41, (total, fam, length)).astype(np.uint8)
    sizes_a = rng.integers(1, fam + 1, (total,)).astype(np.int32)
    bases_b = bases_a.copy()
    quals_b = rng.integers(20, 41, (total, fam, length)).astype(np.uint8)
    sizes_b = sizes_a.copy()
    sizes_b[::4] = 0  # some molecules lack strand B
    return rng, (bases_a, quals_a, sizes_a, bases_b, quals_b, sizes_b)


def run_dryrun_process(coordinator: str, num_processes: int, process_id: int,
                       batch_per_process: int = 8, fam: int = 4, length: int = 32,
                       seed: int = 7, device="cuda", local_devices: int = 2,
                       backend: str | None = None) -> dict:
    """One process of the multi-process dryrun; returns the global stats.

    Every process draws the SAME global batch and slices out its own share
    (a stand-in for each host reading its own BAM shard), so the reduced
    result is checkable independently.  The step is
    ``parallel.mesh.full_pipeline_step`` on the local shards (one fused
    launch per shard), then :func:`all_reduce_stats`.  Then the stream
    wire: a member stream planned over the global mesh
    (``plan_member_shards``, ``stack_member_shards``), each local shard's
    stacked rows voted in one SSCS launch on its device and every real
    family held to ``core.consensus_cpu.consensus_maker``."""
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    initialize(coordinator, num_processes, process_id, backend)
    try:
        mesh = global_mesh(device, local_devices)
        step = full_pipeline_step(mesh.local)
        rng, batch = dryrun_batch(num_processes, batch_per_process, fam, length, seed)
        sizes_b = batch[5]
        total = batch_per_process * num_processes
        lo = process_id * batch_per_process
        hi = lo + batch_per_process
        args = feed_local(mesh, *(x[lo:hi] for x in batch))
        stats = all_reduce_stats(step(*args)[-1]).tolist()

        # the stream wire over the same global mesh, each process feeding
        # only its local shards' slice of the stacked layout (global shard
        # order is process-major, so that slice is contiguous)
        n_dev = mesh.size
        s_sizes = rng.integers(1, 6, (6 * n_dev,)).astype(np.int32)
        m = int(s_sizes.sum())
        s_rows = rng.integers(0, 4, (m, length)).astype(np.uint8)
        s_qrows = rng.integers(20, 41, (m, length)).astype(np.uint8)
        plan = plan_member_shards(s_sizes, n_dev)
        sizes_st, rows_st, qrows_st = stack_member_shards(plan, s_sizes, s_rows, s_qrows)
        cfg = ConsensusConfig()
        order = plan.order()
        starts = np.concatenate([[0], np.cumsum(s_sizes)])
        stream_ok = True
        planes = []
        for j, dev in enumerate(mesh.local.devices):  # dispatch every shard first
            g = process_id * mesh.local.size + j
            rows = slice(g * plan.m_local, (g + 1) * plan.m_local)
            fams = slice(g * plan.nf_local, (g + 1) * plan.nf_local)
            planes.append((g, consensus_vote.vote_wire(
                "raw", torch.from_numpy(rows_st[rows]).to(dev),
                torch.from_numpy(qrows_st[rows]).to(dev), torch.from_numpy(sizes_st[fams]),
                cfg)))
        for g, plane in planes:
            got = plane.cpu().numpy()  # (2, nf_local, L) of global shard g
            for local_row in range(got.shape[1]):
                js = np.nonzero(order == g * plan.nf_local + local_row)[0]
                if not js.size:  # padding slot: all-N, callers drop it
                    continue
                f = int(js[0])
                exp_b, exp_q = consensus_maker(s_rows[starts[f]:starts[f + 1]],
                                               s_qrows[starts[f]:starts[f + 1]])
                if not (np.array_equal(got[0, local_row], exp_b)
                        and np.array_equal(got[1, local_row], exp_q)):
                    stream_ok = False
        return {
            "process_id": process_id,
            "n_processes": dist.get_world_size(),
            "n_global_devices": n_dev,
            "device": str(mesh.local.devices[0]),
            "backend": dist.get_backend(),
            "stream_wire_ok": bool(stream_ok),
            "stream_families": int(s_sizes.size),
            "families": int(stats[0]),
            "duplexes": int(stats[1]),
            "n_count": int(stats[2]),
            "q_sum": int(stats[3]),
            "expect_families": int(total),
            "expect_duplexes": int((sizes_b > 0).sum()),
            # kernel launches in this process (0 on the CPU: plain versions)
            "launches": {"sscs": consensus_vote.launches,
                         "fused": consensus_vote.fused_launches},
        }
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(
        description="multi-process dryrun worker — one process of the rendezvous")
    p.add_argument("--coordinator", required=True, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--local-devices", type=int, default=2,
                   help="shards of this process (laid over the visible cards in turn)")
    p.add_argument("--batch-per-process", type=int, default=8)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the shards run (default cuda)")
    p.add_argument("--dist_backend", choices=BACKENDS, default=None,
                   help="torch.distributed backend (default: nccl on the card, gloo "
                        "on the CPU; NCCL refuses two ranks on one card, so ranks "
                        "sharing a card need gloo)")
    args = p.parse_args(argv)

    result = run_dryrun_process(
        args.coordinator, args.num_processes, args.process_id,
        batch_per_process=args.batch_per_process, device=args.device,
        local_devices=args.local_devices, backend=args.dist_backend)
    print(json.dumps(result), flush=True)
    ok = (result["families"] == result["expect_families"]
          and result["duplexes"] == result["expect_duplexes"]
          and result["stream_wire_ok"])
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
