"""Multi-device sharding: family batches over a mesh of devices.

Port of ``consensuscruncher_tpu/parallel/mesh.py``.  UMI families are
embarrassingly parallel, so the mesh is one ``"families"`` axis: each
device votes its shard of a family batch with the port's kernels, and the
only cross-device traffic is a sum of per-shard ``(4,)`` int32 stats
vectors (the JAX package's ``psum``), plus the gather of the result rows.

In PyTorch's idiom a :class:`Mesh` is a tuple of ``torch.device``s and a
``shard_map`` program is a loop over them: every shard is uploaded and
launched on its own device (the kernel wrappers run each launch under
its planes' card, on that card's current stream) before anything is
downloaded, so the shards of distinct cards overlap.  Outputs and stats
gather on the mesh's first device.  A device may repeat: shards then run
in turn on one card, or on the CPU, where each kernel's plain version
votes its shard.

The JAX programs and their counterparts here, per shard:

- ``_compiled_sharded_step`` (:func:`sharded_consensus_batch`): B1's dense
  form, then torch stats over each family's true length, summed;
- ``_compiled_sharded_vote`` (:func:`sharded_vote_async`): B1's dense form;
- ``_compiled_stream_vote_sharded`` (:func:`stream_vote_sharded`): one B1
  launch on the shard's contiguous run of families, any wire, the
  codebook replicated (it rides in the launch);
- ``_compiled_duplex_sharded`` (:func:`duplex_batch_host_sharded`): the
  elementwise ``ops.duplex.duplex_vote``;
- ``_pipeline_shard_fn`` (:func:`full_pipeline_step`,
  :func:`packed_pipeline_step`, :func:`packed4_pipeline_step`): one B2
  launch (both strands' SSCS and their DCS, stats folded in) on the raw,
  pack8 or pack4 wire, stats summed.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from consensuscruncher_tpu_torch.device import resolve_device
from consensuscruncher_tpu_torch.obs import metrics as obs_metrics
from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.ops import consensus_vote
from consensuscruncher_tpu_torch.ops.consensus_vote import ConsensusConfig
from consensuscruncher_tpu_torch.ops.duplex import duplex_vote
from consensuscruncher_tpu_torch.ops.packing import wire_width
from consensuscruncher_tpu_torch.utils.phred import N

FAMILY_AXIS = "families"


@dataclass(frozen=True)
class Mesh:
    """A 1-D ``"families"`` mesh: the devices its shards run on, in order
    (a device may repeat)."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _visible_devices() -> list[torch.device]:
    """Every CUDA card this process sees (the JAX package's
    ``jax.devices()``); raises without a card, as the port's entry points
    do."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` of ``devices`` (default:
    every visible card)."""
    devs = [torch.device(d) for d in (devices if devices is not None else _visible_devices())]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"asked for {n_devices} devices, only {len(devs)} available")
        devs = devs[:n_devices]
    return Mesh(tuple(devs))


def device_mesh(device: torch.device, n: int) -> Mesh:
    """The ``--devices N`` mesh of a run on ``device``: on the card, shard
    ``k`` on visible card ``k mod count`` (one stderr line says so when
    there are fewer cards than shards: they then take turns on a card); on
    the CPU, ``n`` CPU shards, each voted by the kernels' plain versions.
    Where the JAX package degrades to one device when its mesh is short,
    the port lays the shards over the cards it has; outputs are
    byte-identical at any mesh size in both."""
    if device.type != "cuda":
        return make_mesh(devices=[device] * n)
    cards = _visible_devices()
    if len(cards) < n:
        print(f"--devices {n}: {n} shards over {len(cards)} card(s)", file=sys.stderr,
              flush=True)
    return make_mesh(devices=[cards[k % len(cards)] for k in range(n)])


@dataclass(frozen=True)
class StepStats:
    """Counters of one sharded step, summed over the shards."""

    families: int
    positions: int
    n_positions: int  # positions that failed the vote (emitted as N)
    qual_sum: int

    @staticmethod
    def from_vector(vec) -> "StepStats":
        v = np.asarray(vec).astype(np.int64)
        return StepStats(int(v[0]), int(v[1]), int(v[2]), int(v[3]))


def pad_batch_to_mesh(bases, quals, fam_sizes, mesh: Mesh, lengths=None):
    """Pad the batch axis to a multiple of the mesh size with dummy slots.

    Dummy slots carry ``fam_size == 0`` (and length 0) and are excluded from
    stats and dropped by callers.  Returns ``(bases, quals, fam_sizes,
    lengths, n_real)``; ``lengths`` is None iff it was passed as None.
    """
    n = bases.shape[0]
    size = mesh.size
    cap = ((n + size - 1) // size) * size
    if cap != n:
        pad = cap - n
        bases = np.concatenate([bases, np.zeros((pad,) + bases.shape[1:], bases.dtype)])
        quals = np.concatenate([quals, np.zeros((pad,) + quals.shape[1:], quals.dtype)])
        fam_sizes = np.concatenate([fam_sizes, np.zeros(pad, fam_sizes.dtype)])
        if lengths is not None:
            lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
    return bases, quals, fam_sizes, lengths, n


def _shards(mesh: Mesh, n: int) -> list[tuple[torch.device, slice]]:
    """Each device of ``mesh`` with its even slice of a batch axis of ``n``
    (a multiple of the mesh size, as ``shard_map`` requires)."""
    if n % mesh.size:
        raise ValueError(f"batch axis of {n} is not a multiple of the mesh size {mesh.size} "
                         "(pad it with pad_batch_to_mesh)")
    per = n // mesh.size
    return [(dev, slice(k * per, (k + 1) * per)) for k, dev in enumerate(mesh.devices)]


def _upload(x, rows: slice, dev: torch.device, dtype=None) -> torch.Tensor:
    """Rows ``rows`` of a host array or a tensor on ``dev`` (an upload from
    the host is counted)."""
    t = torch.as_tensor(x[rows])
    if dtype is not None:
        t = t.to(dtype)
    if t.device.type == "cpu":
        obs_metrics.note_transfer("h2d", t.nbytes, dev)
    return t.to(dev)


def _gather(parts: list[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The shards' outputs concatenated on the first one's device."""
    dev0 = parts[0].device
    return torch.cat([p.to(dev0) for p in parts], dim)


def _sum(parts: list[torch.Tensor]) -> torch.Tensor:
    """The shards' ``(4,)`` stats summed on the first one's device (the
    JAX package's ``psum``)."""
    dev0 = parts[0].device
    total = parts[0].to(torch.int64)
    for p in parts[1:]:
        total = total + p.to(dev0, torch.int64)
    return total.to(torch.int32)


def _dense_shard_vote(mesh: Mesh, bases, quals, fam_sizes, config: ConsensusConfig):
    """B1's dense form on every shard, all dispatched: ``[(dev, rows,
    sizes, out_b, out_q)]`` with the outputs on each shard's device."""
    out = []
    for dev, rows in _shards(mesh, bases.shape[0]):
        b = _upload(bases, rows, dev, torch.uint8)
        q = _upload(quals, rows, dev, torch.uint8)
        sizes = torch.as_tensor(fam_sizes[rows]).to(torch.int32)
        out_b, out_q = consensus_vote.consensus_batch(b, q, sizes, config)
        out.append((dev, rows, sizes, out_b, out_q))
    return out


def sharded_vote_async(bases, quals, fam_sizes, mesh: Mesh,
                       config: ConsensusConfig = ConsensusConfig()):
    """One family-sharded vote (no stats): ``(out_b, out_q)`` ``(B, L)``
    uint8 on the mesh's first device.  The batch axis must be a multiple
    of the mesh size (:func:`pad_batch_to_mesh`)."""
    shards = _dense_shard_vote(mesh, bases, quals, fam_sizes, config)
    return _gather([s[3] for s in shards]), _gather([s[4] for s in shards])


def sharded_consensus_batch_async(bases, quals, fam_sizes, mesh: Mesh,
                                  config: ConsensusConfig = ConsensusConfig(), lengths=None):
    """One family-sharded consensus batch: ``(out_b, out_q, stats)`` on the
    mesh's first device, ``stats`` the int32 ``[real, positions, n_count,
    q_sum]`` summed over the shards, counting each family's positions
    below its true ``lengths`` (default: every position).  The batch axis
    must be a multiple of the mesh size (:func:`pad_batch_to_mesh`)."""
    if lengths is None:
        lengths = np.full(np.shape(bases)[0], np.shape(bases)[-1], np.int32)
    shards = _dense_shard_vote(mesh, bases, quals, fam_sizes, config)
    stats = []
    for dev, rows, sizes, out_b, out_q in shards:
        real = sizes.to(dev) > 0
        ln = torch.as_tensor(lengths[rows]).to(dev, torch.int64)
        in_len = torch.arange(out_b.shape[-1], device=dev)[None, :] < ln[:, None]
        counted = real[:, None] & in_len
        stats.append(torch.stack([
            real.sum(), counted.sum(), (counted & (out_b == N)).sum(),
            torch.where(counted, out_q.to(torch.int64), 0).sum()]))
    return _gather([s[3] for s in shards]), _gather([s[4] for s in shards]), _sum(stats)


def sharded_consensus_batch(bases, quals, fam_sizes, mesh: Mesh,
                            config: ConsensusConfig = ConsensusConfig(), lengths=None):
    """Family-sharded consensus over the mesh: ``(out_b, out_q, stats)``,
    the planes on the mesh's first device and ``stats`` a
    :class:`StepStats` (see :func:`sharded_consensus_batch_async`)."""
    out_b, out_q, stats = sharded_consensus_batch_async(bases, quals, fam_sizes, mesh, config,
                                                        lengths)
    return out_b, out_q, StepStats.from_vector(stats.cpu().numpy())


# ------------------------------------------------- sharded member-stream wire

SHARD_MEMBER_QUANTUM = 256  # per-device member-axis padding quantum


@dataclass(frozen=True)
class MemberShardPlan:
    """Host-side layout for one member-stream batch sharded over a mesh.

    ``cuts[k]:cuts[k+1]`` are the family slots of device ``k`` (contiguous,
    balanced by member count); ``order[i]`` is family slot *i*'s row in the
    sharded output (devices pad their family axis to a uniform
    ``nf_local``).  ``m_local`` is the uniform per-device member-row count.
    """

    cuts: tuple[int, ...]
    nf_local: int
    m_local: int

    @property
    def n_dev(self) -> int:
        return len(self.cuts) - 1

    def order(self) -> np.ndarray:
        idx = np.empty(self.cuts[-1], dtype=np.int64)
        for k in range(self.n_dev):
            f0, f1 = self.cuts[k], self.cuts[k + 1]
            idx[f0:f1] = np.arange(f1 - f0, dtype=np.int64) + k * self.nf_local
        return idx


def plan_member_shards(sizes: np.ndarray, n_dev: int,
                       quantum: int = SHARD_MEMBER_QUANTUM) -> MemberShardPlan:
    """Split family slots into ``n_dev`` contiguous chunks balanced by
    member count (whole families only — the per-family vote then needs no
    collective).  Deterministic pure function of (sizes, n_dev), so the
    dispatch and fetch sides can derive the same plan independently."""
    sizes = np.asarray(sizes, dtype=np.int64)
    nf = int(sizes.size)
    ends = np.cumsum(sizes)
    total = int(ends[-1]) if nf else 0
    targets = (np.arange(1, n_dev, dtype=np.int64) * total) // n_dev
    cuts = np.concatenate([[0], np.searchsorted(ends, targets, side="left"), [nf]])
    cuts = np.maximum.accumulate(cuts).astype(np.int64)
    widths = np.diff(cuts)
    starts = np.concatenate([[0], ends])
    members = starts[cuts[1:]] - starts[cuts[:-1]]
    nf_local = 1 << max(0, (int(widths.max(initial=1)) - 1).bit_length())
    m_max = int(members.max(initial=1))
    m_local = max(quantum, -(-m_max // quantum) * quantum)
    return MemberShardPlan(tuple(int(c) for c in cuts), nf_local, m_local)


def stack_member_shards(plan: MemberShardPlan, sizes: np.ndarray,
                        *row_arrays: np.ndarray):
    """Build the stacked device inputs for a plan: per-device chunks of the
    member-row arrays placed at ``k * m_local`` and the per-device family
    sizes at ``k * nf_local``.  Padding rows/slots are zeros — dead by
    construction (a shard's sizes only reference its real rows; the vote
    kernels mask size-0 slots).  Returns ``(sizes_stacked, *rows_stacked)``.
    """
    sizes = np.asarray(sizes, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
    sizes_st = np.zeros(plan.n_dev * plan.nf_local, np.int32)
    outs = [np.zeros((plan.n_dev * plan.m_local,) + a.shape[1:], a.dtype)
            for a in row_arrays]
    for k in range(plan.n_dev):
        f0, f1 = plan.cuts[k], plan.cuts[k + 1]
        sizes_st[k * plan.nf_local : k * plan.nf_local + (f1 - f0)] = sizes[f0:f1]
        r0, r1 = int(starts[f0]), int(starts[f1])
        for a, out in zip(row_arrays, outs):
            out[k * plan.m_local : k * plan.m_local + (r1 - r0)] = a[r0:r1]
    return (sizes_st, *outs)


def stream_vote_sharded(mesh: Mesh, wire: str, a, b, sizes,
                        config: ConsensusConfig = ConsensusConfig(), out_len: int | None = None):
    """Vote one member-stream batch sharded over ``mesh``.

    ``a``/``b``/``sizes`` are the single-device wire arrays on the host
    (see ``consensus_segment.encode_member_batch``: the raw planes, or the
    packed rows and their codebook).  Device ``k`` gets the contiguous run
    of families ``plan.cuts[k]:plan.cuts[k+1]`` of
    ``plan_member_shards(sizes, mesh.size)`` and their member rows, and
    votes them in one launch of the SSCS kernel (``vote_wire``; a device
    with no family launches nothing); every shard is dispatched before
    any is gathered.  Returns the ``(2, n_dev * nf_local, out_len)`` uint8
    planes on the mesh's first device, in the JAX package's stacked row
    order: the caller reorders rows with ``plan.order()`` (padding slots
    are ``(N, 0)``).  The JAX function's ``num``/``den``/``qual_threshold``/
    ``qual_cap`` are ``config`` here, as the port's ``stream_vote`` takes
    them; its ``member_cap`` has no counterpart (B1 takes any family
    size)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    plan = plan_member_shards(sizes, mesh.size)
    ends = np.concatenate([[0], np.cumsum(sizes)])
    book = None if wire == "raw" else torch.as_tensor(b)
    length = wire_width(wire, a) if out_len is None else int(out_len)
    parts = []
    for k, dev in enumerate(mesh.devices):
        f0, f1 = plan.cuts[k], plan.cuts[k + 1]
        if f1 == f0:
            continue
        rows = slice(int(ends[f0]), int(ends[f1]))
        rows_k = _upload(a, rows, dev)
        second = _upload(b, rows, dev) if wire == "raw" else book
        parts.append((k, f1 - f0, consensus_vote.vote_wire(
            wire, rows_k, second, torch.from_numpy(sizes[f0:f1]), config, length=length)))
    dev0 = mesh.devices[0]
    out = torch.empty((2, plan.n_dev * plan.nf_local, length), dtype=torch.uint8, device=dev0)
    out[0].fill_(N)
    out[1].zero_()
    for k, w, planes in parts:
        out[:, k * plan.nf_local:k * plan.nf_local + w] = planes.to(dev0)
    return out


def duplex_batch_host_sharded(seq1, qual1, seq2, qual2, mesh: Mesh, qual_cap: int):
    """Mesh twin of ``ops.duplex.duplex_batch_host``: shard the pair axis
    (padded to a mesh multiple with dummy rows), vote every shard on its
    device, then download each; host ``(bases, quals)`` of the ``n``
    pairs."""
    n = seq1.shape[0]
    size = mesh.size
    cap = -(-max(n, 1) // size) * size
    planes = [np.ascontiguousarray(x, dtype=np.uint8) for x in (seq1, qual1, seq2, qual2)]
    if cap != n:
        pad = ((0, cap - n), (0, 0))
        planes = [np.pad(x, pad) for x in planes]
    outs = []
    for dev, rows in _shards(mesh, cap):
        outs.append(duplex_vote(*(_upload(x, rows, dev) for x in planes),
                                qual_cap=int(qual_cap)))
    got = []
    for out_b, out_q in outs:
        obs_metrics.note_transfer("d2h", out_b.nbytes + out_q.nbytes, out_b.device)
        got.append((out_b.cpu().numpy(), out_q.cpu().numpy()))
    return (np.concatenate([g[0] for g in got])[:n],
            np.concatenate([g[1] for g in got])[:n])


# ------------------------------------------------------ fused pipeline steps


def _pipeline_step(mesh: Mesh, config: ConsensusConfig, wire: str, length: int | None):
    """The per-shard SSCS + DCS of the three step builders: each shard's
    strand batches, ``(n, F, W)`` wire rows, join one member stream
    (strand A's families at rows ``i * F``, strand B's after them) and
    vote in one launch of the fused kernel with its stats; planes gather
    and stats sum on the mesh's first device.  The ``mesh.inputs`` span
    covers a shard's inputs: its views (or uploads), the strands joined,
    the sizes and starts."""

    def step(a_a, b_a, sizes_a, a_b, b_b, sizes_b):
        """``b_*``: the raw wire's quals planes, or the packed wires'
        codebook (the same for both strands)."""
        shards = []
        for dev, rows in _shards(mesh, np.shape(sizes_a)[0]):
            with obs_trace.span("mesh.inputs"):
                n, f, _w = np.shape(a_a[rows])
                flat = [_upload(x, rows, dev, torch.uint8).reshape(n * f, -1)
                        for x in (a_a, a_b)]
                if wire == "raw":
                    flat_q = [_upload(x, rows, dev, torch.uint8).reshape(n * f, -1)
                              for x in (b_a, b_b)]
                    second = torch.cat(flat_q)
                else:
                    second = torch.as_tensor(b_a)  # the codebook rides in the launch
                sizes = torch.cat([torch.as_tensor(s[rows]).to(torch.int64)
                                   for s in (sizes_a, sizes_b)])
                starts = torch.arange(n, dtype=torch.int64) * f
                members = torch.cat(flat)
                starts = torch.cat([starts, starts + n * f])
            planes, stats = consensus_vote.duplex_wire(
                wire, members, second, sizes, config,
                length=flat[0].shape[1] if length is None else length, starts=starts)
            shards.append((planes, stats))
        planes = _gather([p for p, _s in shards], 1)
        return (*planes, _sum([s for _p, s in shards]))

    return step


def full_pipeline_step(mesh: Mesh, config: ConsensusConfig = ConsensusConfig()):
    """The whole-pipeline device step for one sharded batch: per shard,
    the SSCS of a batch of strand-A families and of strand-B families and
    their DCS (both strands present), with the stats ``[real, duplexes,
    n_count, q_sum]`` summed over the shards.

    Returns ``fn(bases_a, quals_a, sizes_a, bases_b, quals_b, sizes_b) ->
    (sscs_a, qual_a, sscs_b, qual_b, dcs, dcs_qual, stats)``, the planes
    ``(B, L)`` uint8 and ``stats`` ``(4,)`` int32 on the mesh's first
    device; the batch axis must be a multiple of the mesh size."""
    return _pipeline_step(mesh, config, "raw", None)


def packed_pipeline_step(mesh: Mesh, config: ConsensusConfig = ConsensusConfig()):
    """:func:`full_pipeline_step` over the 1-byte wire (``ops.packing.pack``,
    pack8): ``fn(packed_a, sizes_a, packed_b, sizes_b, codebook) -> (sscs_a,
    qual_a, sscs_b, qual_b, dcs, dcs_qual, stats)``, the kernel decoding the
    wire with the ``(16,)`` codebook replicated."""
    step = _pipeline_step(mesh, config, "pack8", None)
    return lambda packed_a, sizes_a, packed_b, sizes_b, codebook: step(
        packed_a, codebook, sizes_a, packed_b, codebook, sizes_b)


def packed4_pipeline_step(mesh: Mesh, length: int, config: ConsensusConfig = ConsensusConfig()):
    """:func:`full_pipeline_step` over the 4-bit wire (``ops.packing.pack4``),
    ``length`` the true (pre-nibble-padding) position count:
    ``fn(packed_a, sizes_a, packed_b, sizes_b, codebook4) -> (sscs_a, qual_a,
    sscs_b, qual_b, dcs, dcs_qual, stats)``.  Pure-ACGT members only: the
    PAD base of a dead slot cannot ride pack4 (rewrite dead slots first;
    the kernel never reads them)."""
    step = _pipeline_step(mesh, config, "pack4", int(length))
    return lambda packed_a, sizes_a, packed_b, sizes_b, codebook4: step(
        packed_a, codebook4, sizes_a, packed_b, codebook4, sizes_b)
