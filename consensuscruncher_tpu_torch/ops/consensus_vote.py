"""The majority votes: CUDA kernels, plain PyTorch versions, launch counts.

One hand-written CUDA kernel template in ``csrc/consensus_vote.cu``, its
vote in ``csrc/vote_state.cuh``, in two forms:

- the SSCS vote, port of the TPU kernel ``consensuscruncher_tpu/ops/
  consensus_pallas.py:_vote_kernel`` (:func:`vote_wire`, and its raw
  instantiation :func:`vote_members`);
- the fused duplex vote, port of ``consensus_pallas.py:
  _fused_duplex_kernel``: both strands' SSCS votes and their DCS in one
  launch, with the stream step's stats (:func:`duplex_wire`, and its raw
  two-strand instantiation :func:`duplex_members`).

Both read a member-stream wire (``ops.packing.WIRES``: raw, pack8, pack6,
pack4) and decode it in the kernel.  Family ``f``'s members are rows
``starts[f] .. starts[f] + sizes[f] - 1`` of the wire's ``M`` rows, with
``starts`` the exclusive cumsum of ``sizes`` by default.  The dense
``(B, F, L)`` forms of the TPU kernels are the same streams with
``starts = arange(B) * F`` (:func:`consensus_batch`, :func:`duplex_batch`).
Each call plans its tiles on the host (``ops.tiles``), uploads the family
records and the tile table in one pinned copy, and launches the kernel once.

Semantics (reference parity: ``ConsensusCruncher/consensus_helper.py:
consensus_maker``, pinned in ``core/consensus_cpu.py``): low-qual members
vote N; the modal lane wins, ties to the earliest first-seen member; the
vote passes iff ``modal != N and max_count * den >= num * size and size >
0`` in int32; a pass keeps ``min(agreeing qual sum, qual_cap)``, anything
else is ``(N, 0)``.  The duplex combine keeps a base iff both strands voted
it and it is below N, with quality ``min(qa + qb, qual_cap)``.

The SSCS vote carries the QC rider when it is given each family's true
length (``qc_lengths``): per position, the batch's sum of votes (members
whose effective lane is A, C, G, T or N) and of votes that disagree with
the modal lane, failed votes included, at positions below each family's
length — the ``with_qc`` planes of the JAX package's ``_stream_vote_fn``.
On the card it is a reduction inside the vote kernel (its ``kQc``
instantiations); the plain version reduces the plain vote's counts.

The wrappers launch the kernel for CUDA tensors (or raise) and run the
plain version (:func:`vote_wire_plain`, :func:`duplex_wire_plain`: the torch
decode ``ops.packing.unpack_wire``, then :func:`vote_members_plain` /
:func:`duplex_members_plain` + :func:`duplex_stats`) only for tensors on the
CPU.  :func:`prepare_wire` / :func:`prepare_duplex_wire` return the planned
launch, so a caller can time the bare kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from consensuscruncher_tpu_torch.core.consensus_cpu import (
    DEFAULT_CUTOFF,
    DEFAULT_QUAL_CAP,
    DEFAULT_QUAL_THRESHOLD,
    cutoff_fraction,
)
from consensuscruncher_tpu_torch.obs import metrics as obs_metrics
from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.ops import tiles
from consensuscruncher_tpu_torch.ops.duplex import duplex_vote
from consensuscruncher_tpu_torch.ops.packing import WIRES, unpack_wire, wire_width
from consensuscruncher_tpu_torch.utils.phred import N, NUM_BASES

# Kernel launches made on CUDA tensors since the last reset (one per call of
# the C entry point, which launches its kernel exactly once): the SSCS vote
# (of which qc_launches carried the QC rider), and the fused duplex vote.
launches = 0
qc_launches = 0
fused_launches = 0
# The ops.tiles.TilePlan of the last launch prepared (its summary() says
# which path, staged, direct or mixed, the tiles took).
last_plan: tiles.TilePlan | None = None

_lib = None
# the kernel's shapes per form, SSCS (False) and duplex (True): cct_tile_constants
_layouts: dict[bool, tiles.Layout] = {}
_grids: dict[tuple[int, int, int, int], int] = {}


@dataclass(frozen=True)
class ConsensusConfig:
    """Consensus parameters (port of ``ops/consensus_tpu.ConsensusConfig``)."""

    cutoff: float = DEFAULT_CUTOFF
    qual_threshold: int = DEFAULT_QUAL_THRESHOLD
    qual_cap: int = DEFAULT_QUAL_CAP

    @property
    def cutoff_rational(self) -> tuple[int, int]:
        return cutoff_fraction(self.cutoff)

    def check_family_size(self, max_size: int) -> None:
        """The cutoff cross-multiply runs in int32: refuse families whose
        ``size * max(num, den)`` could overflow it."""
        num, den = self.cutoff_rational
        if max_size * max(num, den) >= 2**31:
            raise ValueError(
                f"family of {max_size} members with cutoff {num}/{den} would "
                "overflow the int32 cutoff compare — split the family or "
                "coarsen the cutoff")


def config_from_reference(ref) -> ConsensusConfig:
    """The port's config carrying the same values as any object with
    ``cutoff``/``qual_threshold``/``qual_cap`` attributes (such as the JAX
    package's ``ConsensusConfig``)."""
    return ConsensusConfig(cutoff=float(ref.cutoff),
                           qual_threshold=int(ref.qual_threshold),
                           qual_cap=int(ref.qual_cap))


def _family_checks(rows, width, sizes, config, length, starts):
    """Validate a vote's families against ``rows`` member rows of ``width``
    positions on the host; returns the sizes (int64, CPU), the starts (int64,
    CPU, or None for the exclusive cumsum) and the vote length."""
    length = width if length is None else int(length)
    if not 0 <= length <= width:
        raise ValueError(f"length {length} outside [0, {width}]")
    sizes = torch.as_tensor(sizes).to(device="cpu", dtype=torch.int64)
    if sizes.dim() != 1:
        raise ValueError("sizes must be 1-D")
    if starts is not None:
        starts = torch.as_tensor(starts).to(device="cpu", dtype=torch.int64)
        if starts.shape != sizes.shape:
            raise ValueError("starts and sizes must match")
    if sizes.numel():
        if int(sizes.min()) < 0:
            raise ValueError("family sizes must be >= 0")
        if starts is None:
            outside = int(sizes.sum()) > rows
        else:
            outside = int((starts + sizes).max()) > rows or int(starts.min()) < 0
        if outside:
            raise ValueError("family rows run outside the member planes")
        config.check_family_size(int(sizes.max()))
    return sizes, starts, length


def _checks(bases, quals, sizes, config, length, starts):
    """Validate a raw vote's planes and families (see :func:`_family_checks`)."""
    if bases.dtype != torch.uint8 or quals.dtype != torch.uint8:
        raise TypeError("bases and quals must be uint8")
    if bases.dim() != 2 or bases.shape != quals.shape:
        raise ValueError(f"bases/quals must be matching (M, L) planes, got "
                         f"{tuple(bases.shape)} and {tuple(quals.shape)}")
    return _family_checks(bases.shape[0], bases.shape[1], sizes, config, length, starts)


def _wire_checks(wire, a, b, sizes, config, length, starts, qc_lengths=None):
    """Validate one wire batch (``a``, ``b`` as ``unpack_wire`` takes them)
    and its families; returns as :func:`_family_checks`, plus the QC
    rider's lengths (int32, CPU) or None."""
    if wire not in WIRES:
        raise ValueError(f"unknown wire {wire!r}")
    if wire == "raw":
        checked = _checks(a, b, sizes, config, length, starts)
        width = a.shape[1]
    else:
        if a.dtype != torch.uint8 or a.dim() != 2:
            raise TypeError(f"{wire} rows must be a 2-D uint8 tensor")
        book = 4 if wire == "pack4" else 16
        if torch.as_tensor(b).numel() != book:
            raise ValueError(f"{wire} needs a codebook of {book} entries")
        width = wire_width(wire, a)
        checked = _family_checks(a.shape[0], width, sizes, config, length, starts)
    return (*checked, _qc_checks(qc_lengths, checked[0], width))


def _qc_checks(qc_lengths, sizes, width):
    """The QC rider's per-family true lengths on the host: one per family,
    each in ``[0, width]``."""
    if qc_lengths is None:
        return None
    lengths = torch.as_tensor(qc_lengths).to(device="cpu", dtype=torch.int64)
    if lengths.shape != sizes.shape:
        raise ValueError(f"qc_lengths must hold one length per family: "
                         f"{tuple(lengths.shape)} for {tuple(sizes.shape)} sizes")
    if lengths.numel() and (int(lengths.min()) < 0 or int(lengths.max()) > width):
        raise ValueError(f"qc_lengths outside [0, {width}]")
    return lengths.to(torch.int32)


def _exclusive_cumsum(sizes: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(sizes, 0, dtype=torch.int64) - sizes


def _default_starts(sizes, starts):
    return _exclusive_cumsum(sizes) if starts is None else starts


def duplex_stats(sizes_a: torch.Tensor, sizes_b: torch.Tensor, dcs_b: torch.Tensor,
                 dcs_q: torch.Tensor) -> torch.Tensor:
    """``[real, duplexes, n_count, q_sum]`` int32 on the planes' device:
    pairs with any strand, pairs with both, N bases and the quality sum of
    the DCS of the pairs with both (the plain version of the kernel's
    stats)."""
    sizes_a, sizes_b = sizes_a.to(dcs_b.device), sizes_b.to(dcs_b.device)
    both = (sizes_a > 0) & (sizes_b > 0)
    real = ((sizes_a > 0) | (sizes_b > 0)).sum()
    n_count = ((dcs_b == N) & both[:, None]).sum()
    q_sum = torch.where(both[:, None], dcs_q.to(torch.int64), 0).sum()
    return torch.stack([real, both.sum(), n_count, q_sum]).to(torch.int32)


# ------------------------------------------------------------ wire wrappers


def vote_wire(wire: str, a: torch.Tensor, b, sizes,
              config: ConsensusConfig = ConsensusConfig(), length: int | None = None,
              starts: torch.Tensor | None = None, qc_lengths=None):
    """Vote every family of a member-stream wire batch.

    ``wire`` names the layout (``ops.packing.WIRES``): ``a``/``b`` are the
    raw ``(M, L)`` bases and quals planes, or the packed ``(M, W)`` rows and
    their codebook (on any device; a host codebook spares a device sync);
    ``sizes``: ``(NF,)`` family sizes (any device, 0 = empty slot);
    ``length``: vote positions ``[0, length)`` only (default: every
    position the rows hold); ``starts``: first row of each family (default:
    exclusive cumsum of ``sizes``).  Returns a stacked ``(2, NF, length)``
    uint8 tensor (consensus bases, consensus quals) on ``a``'s device; empty
    slots come back all ``(N, 0)``.

    ``qc_lengths``: ``(NF,)`` true lengths of the families (any device);
    given, the call also runs the QC rider and returns ``(planes, qc)``,
    ``qc`` the ``(2, length)`` int32 sums of votes and of disagreeing
    votes over the families at positions below their lengths.
    """
    if a.device.type == "cpu":
        return vote_wire_plain(wire, a, b, sizes, config, length, starts, qc_lengths)
    job = prepare_wire(wire, a, b, sizes, config, length, starts, qc_lengths)
    planes = job()[0]
    return planes if qc_lengths is None else (planes, job.qc)


def prepare_wire(wire, a, b, sizes, config: ConsensusConfig = ConsensusConfig(),
                 length=None, starts=None, qc_lengths=None) -> "TileLaunch":
    """The checked, planned and uploaded launch of :func:`vote_wire` on
    CUDA tensors; calling it launches the kernel once (its QC sums, with
    ``qc_lengths``, in ``.qc``)."""
    with obs_trace.span("vote.checks"):
        sizes, starts, length, qc_lengths = _wire_checks(wire, a, b, sizes, config, length,
                                                         starts, qc_lengths)
        strand = _card_wire(wire, a, b, sizes, starts)
    return _prepare(wire, [strand], _book(wire, b), config, length, duplex=False,
                    qc_lengths=qc_lengths)


def duplex_wire(wire: str, a: torch.Tensor, b, sizes,
                config: ConsensusConfig = ConsensusConfig(), length: int | None = None,
                starts: torch.Tensor | None = None, packed_out: bool = False):
    """Fused SSCS + DCS vote of one member-stream wire batch.

    ``wire``, ``a``, ``b`` as :func:`vote_wire`; ``sizes``: ``(2P,)`` family
    slots, strand A of pair ``p`` in slot ``p`` and strand B in slot
    ``P + p`` (size 0 = absent strand); ``starts`` default to the exclusive
    cumsum of the ``2P`` sizes.  Returns ``(planes, stats)`` on ``a``'s
    device: ``planes`` the ``(6, P, length)`` uint8 SSCS-a bases, SSCS-a
    quals, SSCS-b bases, SSCS-b quals, DCS bases, DCS quals, or with
    ``packed_out`` the ``(3, P, length)`` ``sscs_a | sscs_b << 3``, qa, qb;
    ``stats`` the int32 ``[real, duplexes, n_count, q_sum]``.
    """
    if a.device.type == "cpu":
        return duplex_wire_plain(wire, a, b, sizes, config, length, starts, packed_out)
    return prepare_duplex_wire(wire, a, b, sizes, config, length, starts, packed_out)()


def _pairs(sizes: torch.Tensor) -> int:
    if sizes.shape[0] % 2:
        raise ValueError(f"duplex slots must pair up, got {sizes.shape[0]} sizes")
    return sizes.shape[0] // 2


def prepare_duplex_wire(wire, a, b, sizes, config: ConsensusConfig = ConsensusConfig(),
                        length=None, starts=None, packed_out=False) -> "TileLaunch":
    """The checked, planned and uploaded launch of :func:`duplex_wire` on
    CUDA tensors; calling it launches the kernel once."""
    with obs_trace.span("vote.checks"):
        sizes, starts, length, _qc = _wire_checks(wire, a, b, sizes, config, length, starts)
        n = _pairs(sizes)
        contiguous = starts is None  # each strand's slots are then contiguous rows
        starts = _default_starts(sizes, starts)
        strands = [_card_wire(wire, a, b, sizes[:n], starts[:n], contiguous),
                   _card_wire(wire, a, b, sizes[n:], starts[n:], contiguous)]
    return _prepare(wire, strands, _book(wire, b), config, length, duplex=True,
                    packed_out=packed_out)


# ------------------------------------------------------ raw instantiations


def vote_members(bases: torch.Tensor, quals: torch.Tensor, sizes: torch.Tensor,
                 config: ConsensusConfig = ConsensusConfig(),
                 length: int | None = None,
                 starts: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`vote_wire` on the raw wire: ``(M, L)`` uint8 ``bases`` and
    ``quals`` planes on one device (rows may be strided).  Returns the
    stacked ``(2, NF, length)`` uint8 planes on the planes' device."""
    if bases.device.type == "cpu":
        return vote_members_plain(bases, quals, sizes, config, length, starts)
    return prepare_wire("raw", bases, quals, sizes, config, length, starts)()[0]


def duplex_members(bases_a: torch.Tensor, quals_a: torch.Tensor, sizes_a,
                   bases_b: torch.Tensor, quals_b: torch.Tensor, sizes_b,
                   config: ConsensusConfig = ConsensusConfig(),
                   length: int | None = None,
                   starts_a: torch.Tensor | None = None,
                   starts_b: torch.Tensor | None = None) -> torch.Tensor:
    """Fused SSCS + DCS vote of ``P`` strand pairs on the raw wire.

    Each strand is a member stream as :func:`vote_members` takes it
    (``(M, L)`` uint8 planes, ``(P,)`` sizes, optional starts); pair ``p``
    is family ``p`` of strand A with family ``p`` of strand B.  The stream
    form passes one member stream as both strands, with ``starts_a`` and
    ``starts_b`` picking its A and B families.  Returns a stacked
    ``(6, P, length)`` uint8 tensor on the planes' device: SSCS-a bases,
    SSCS-a quals, SSCS-b bases, SSCS-b quals, DCS bases, DCS quals.
    """
    if bases_a.device.type == "cpu":
        strand_a, strand_b, length = _duplex_checks(
            (bases_a, quals_a, sizes_a, starts_a), (bases_b, quals_b, sizes_b, starts_b),
            config, length)
        return duplex_members_plain(*strand_a[:3], *strand_b[:3], config, length,
                                    strand_a[3], strand_b[3])
    return prepare_duplex_members(bases_a, quals_a, sizes_a, bases_b, quals_b, sizes_b,
                                  config, length, starts_a, starts_b)()[0]


def prepare_duplex_members(bases_a, quals_a, sizes_a, bases_b, quals_b, sizes_b,
                           config: ConsensusConfig = ConsensusConfig(), length=None,
                           starts_a=None, starts_b=None) -> "TileLaunch":
    """The checked, planned and uploaded launch of :func:`duplex_members` on
    CUDA planes; calling it launches the kernel once."""
    strand_a, strand_b, length = _duplex_checks(
        (bases_a, quals_a, sizes_a, starts_a), (bases_b, quals_b, sizes_b, starts_b),
        config, length)
    strands = [_card_strand(*strand_a), _card_strand(*strand_b)]
    return _prepare("raw", strands, _book("raw", None), config, length, duplex=True)


def _duplex_checks(strand_a, strand_b, config, length):
    """Validate both strands of a duplex vote on the host (each as
    :func:`_checks` does, at one vote length; equal pair counts; one
    device).  Returns the checked ``(bases, quals, sizes, starts)`` strands
    and the length."""
    bases_a, quals_a, sizes_a, starts_a = strand_a
    bases_b, quals_b, sizes_b, starts_b = strand_b
    if len({bases_a.device, quals_a.device, bases_b.device, quals_b.device}) != 1:
        raise ValueError("both strands' planes must lie on one device")
    if bases_a.dim() == 2 and length is None:
        length = bases_a.shape[1]
    sizes_a, starts_a, length = _checks(bases_a, quals_a, sizes_a, config, length, starts_a)
    sizes_b, starts_b, length = _checks(bases_b, quals_b, sizes_b, config, length, starts_b)
    if sizes_a.shape != sizes_b.shape:
        raise ValueError(f"strands must pair up: {sizes_a.shape[0]} families "
                         f"on strand A, {sizes_b.shape[0]} on strand B")
    return ((bases_a, quals_a, sizes_a, starts_a),
            (bases_b, quals_b, sizes_b, starts_b), length)


def consensus_batch(bases: torch.Tensor, quals: torch.Tensor, fam_sizes,
                    config: ConsensusConfig = ConsensusConfig(), qc: bool = False,
                    policy="majority"):
    """Dense form, the port of ``consensus_batch_pallas``: ``(B, F, L)``
    uint8 planes + ``(B,)`` sizes -> ``(out_b, out_q)`` ``(B, L)`` uint8.
    Member slots ``>= size`` are never read.  Same kernel, with family ``i``
    at rows ``i * F ..`` of the flattened ``(B * F, L)`` stream.

    ``qc``: also return the dense wire's QC rider, ``(out_b, out_q, qc)``
    with ``qc`` the ``(2, L)`` int32 sums over the batch of votes and of
    votes disagreeing with the modal lane at every position of the padded
    width (the ``with_qc`` output of the JAX package's ``majority_family_
    vote`` summed over the batch: no length mask, so a live member's
    padding past its family's length votes N where its qual 0 fails the
    threshold, and joins no lane where it passes).  It is the stream
    rider's kernel form with every family's length set to ``L``.

    ``policy`` (a name or a ``policies.VotePolicy``): the kernel runs the
    majority default; any other policy votes the batch with its
    ``family_vote_fn`` (torch ops on the planes' device), the JAX package's
    ``_compiled_batch_fn``, with the same rider."""
    b, f, length = bases.shape
    sizes = torch.as_tensor(fam_sizes).to(device="cpu", dtype=torch.int64)
    if sizes.numel() and int(sizes.max()) > f:
        raise ValueError(f"family size exceeds the member capacity {f}")
    policy = _policy(policy)
    if policy is not None:
        num, den = config.cutoff_rational
        out = policy.family_vote_fn(num=num, den=den,
                                    qual_threshold=int(config.qual_threshold),
                                    qual_cap=int(config.qual_cap), with_qc=qc)(
            bases, quals, sizes.to(bases.device))
        if not qc:
            return out
        return out[0], out[1], torch.stack([out[2].sum(0, dtype=torch.int32),
                                            out[3].sum(0, dtype=torch.int32)])
    starts = torch.arange(b, dtype=torch.int64) * f
    flat_b, flat_q = bases.reshape(b * f, length), quals.reshape(b * f, length)
    if not qc:
        out = vote_members(flat_b, flat_q, sizes, config, starts=starts)
        return out[0], out[1]
    out, sums = vote_wire("raw", flat_b, flat_q, sizes, config, starts=starts,
                          qc_lengths=torch.full((b,), length, dtype=torch.int32))
    return out[0], out[1], sums


def _policy(policy):
    """The resolved ``policies.VotePolicy``, or None for the majority
    default (which the kernels run)."""
    from consensuscruncher_tpu_torch.policies import DEFAULT_POLICY, get_policy

    policy = get_policy(policy)
    return None if policy.name == DEFAULT_POLICY else policy


def duplex_batch(bases_a: torch.Tensor, quals_a: torch.Tensor, sizes_a,
                 bases_b: torch.Tensor, quals_b: torch.Tensor, sizes_b,
                 config: ConsensusConfig = ConsensusConfig(), policy="majority"):
    """Dense form, the port of ``duplex_batch_pallas``: two ``(B, F, L)``
    uint8 strand batches (pairs aligned on the batch axis) + ``(B,)`` sizes
    each -> the six ``(B, L)`` uint8 planes ``(sscs_a_b, sscs_a_q,
    sscs_b_b, sscs_b_q, dcs_b, dcs_q)``.  Member slots ``>= size`` are
    never read; no family-major transpose and no batch padding.

    ``policy``: the fused kernel runs the majority default.  Under any
    other policy, as in the reference, each strand is voted by
    :func:`consensus_batch` under that policy and the pair combined by
    ``ops.duplex.duplex_vote`` with the both-strands-present mask."""
    if not bases_a.shape == quals_a.shape == bases_b.shape == quals_b.shape:
        raise ValueError(f"strand batches must share a shape, got "
                         f"{tuple(bases_a.shape)} vs {tuple(bases_b.shape)}")
    b, f, length = bases_a.shape
    config.check_family_size(f)  # the int32 cutoff guard, as the TPU wrapper's
    sizes = [torch.as_tensor(s).to(device="cpu", dtype=torch.int64)
             for s in (sizes_a, sizes_b)]
    if any(s.numel() and int(s.max()) > f for s in sizes):
        raise ValueError(f"family size exceeds the member capacity {f}")
    if _policy(policy) is not None:
        sa_b, sa_q = consensus_batch(bases_a, quals_a, sizes[0], config, policy=policy)
        sb_b, sb_q = consensus_batch(bases_b, quals_b, sizes[1], config, policy=policy)
        both = ((sizes[0] > 0) & (sizes[1] > 0)).to(sa_b.device)[:, None]
        dcs_b, dcs_q = duplex_vote(sa_b, sa_q, sb_b, sb_q, qual_cap=int(config.qual_cap),
                                   agree_mask=both)
        return sa_b, sa_q, sb_b, sb_q, dcs_b, dcs_q
    starts = torch.arange(b, dtype=torch.int64) * f
    out = duplex_members(bases_a.reshape(b * f, length), quals_a.reshape(b * f, length),
                         sizes[0], bases_b.reshape(b * f, length),
                         quals_b.reshape(b * f, length), sizes[1], config,
                         starts_a=starts, starts_b=starts)
    return tuple(out)


# ------------------------------------------------------------ plain versions


def vote_wire_plain(wire, a, b, sizes, config: ConsensusConfig = ConsensusConfig(),
                    length=None, starts=None, qc_lengths=None):
    """Plain version of :func:`vote_wire` on any device: the torch decode
    (``ops.packing.unpack_wire``), then :func:`vote_members_plain`."""
    bases, quals = unpack_wire(wire, a, torch.as_tensor(b).to(a.device))
    return vote_members_plain(bases, quals, sizes, config, length, starts, qc_lengths)


def duplex_wire_plain(wire, a, b, sizes, config: ConsensusConfig = ConsensusConfig(),
                      length=None, starts=None, packed_out=False):
    """Plain version of :func:`duplex_wire` on any device: the torch
    decode, :func:`duplex_members_plain` over the A and B slots, and
    :func:`duplex_stats`."""
    bases, quals = unpack_wire(wire, a, torch.as_tensor(b).to(a.device))
    sizes, starts, length = _checks(bases, quals, sizes, config, length, starts)
    n = _pairs(sizes)
    starts = _default_starts(sizes, starts)
    out = duplex_members_plain(bases, quals, sizes[:n], bases, quals, sizes[n:],
                               config, length, starts[:n], starts[n:])
    stats = duplex_stats(sizes[:n], sizes[n:], out[4], out[5])
    if packed_out:
        out = torch.stack([out[0] | out[2] << 3, out[1], out[3]])
    return out, stats


def vote_members_plain(bases, quals, sizes, config: ConsensusConfig = ConsensusConfig(),
                       length: int | None = None, starts=None, qc_lengths=None):
    """Plain PyTorch version of the SSCS vote on any device: gather each
    family into a dense ``(NF, cap, length)`` block (``cap`` = largest
    family) and reduce over the member axis, lane by lane — the vote's
    state machine written as tensor ops.  With ``qc_lengths``, returns
    ``(planes, qc)``: the QC rider's ``(2, length)`` int32 sums (see
    :func:`vote_wire`) reduced from the same lane counts."""
    sizes, starts, length = _checks(bases, quals, sizes, config, length, starts)
    qc_lengths = _qc_checks(qc_lengths, sizes, bases.shape[1])
    dev = bases.device
    nf = sizes.shape[0]
    out = torch.empty((2, nf, length), dtype=torch.uint8, device=dev)
    out[0].fill_(N)
    out[1].zero_()
    qc = None if qc_lengths is None else torch.zeros((2, length), dtype=torch.int32, device=dev)
    if nf == 0 or length == 0 or bases.shape[0] == 0:
        return out if qc is None else (out, qc)
    num, den = config.cutoff_rational
    sizes = sizes.to(dev)
    starts = _exclusive_cumsum(sizes) if starts is None else starts.to(dev)
    cap = max(1, int(sizes.max()))
    rank = torch.arange(cap, device=dev)
    valid = rank[None, :] < sizes[:, None]                           # (NF, cap)
    rows = torch.where(valid, starts[:, None] + rank[None, :], 0)
    db = bases[:, :length][rows].to(torch.int32)                     # (NF, cap, L)
    dq = quals[:, :length][rows].to(torch.int32)
    member = valid[:, :, None]
    qual_ok = (dq >= int(config.qual_threshold)) & member
    eff = torch.where(qual_ok, db, N)
    rank3 = rank[None, :, None].to(torch.int32)
    counts, firsts, qsums = [], [], []
    for k in range(NUM_BASES):
        eq = (eff == k) & member
        counts.append(eq.sum(1, dtype=torch.int32))
        firsts.append(torch.where(eq, rank3, cap).amin(1))
        qsums.append(torch.where(qual_ok & (db == k), dq, 0).sum(1, dtype=torch.int32))
    count = torch.stack(counts, -1)                                  # (NF, L, 5)
    max_count = count.amax(-1)
    cand = torch.where(count == max_count[..., None], torch.stack(firsts, -1), cap + 1)
    modal = cand.argmin(-1)                    # first lane among equal minima
    qsum = torch.stack(qsums, -1).gather(-1, modal[..., None])[..., 0]
    size = sizes[:, None].to(torch.int32)
    passed = (modal != N) & (max_count * den >= num * size) & (size > 0)
    out[0] = torch.where(passed, modal, N).to(torch.uint8)
    out[1] = torch.where(passed, qsum.clamp(max=int(config.qual_cap)), 0).to(torch.uint8)
    if qc is None:
        return out
    # the rider: every position below the family's length, passed or not
    votes = count.sum(-1)
    live = torch.arange(length, device=dev)[None, :] < qc_lengths.to(dev)[:, None]
    qc[0] = torch.where(live, votes, 0).sum(0)
    qc[1] = torch.where(live, votes - max_count, 0).sum(0)
    return out, qc


def duplex_members_plain(bases_a, quals_a, sizes_a, bases_b, quals_b, sizes_b,
                         config: ConsensusConfig = ConsensusConfig(),
                         length: int | None = None, starts_a=None,
                         starts_b=None) -> torch.Tensor:
    """Plain PyTorch version of the fused vote on any device: the unfused
    chain it replaces — one :func:`vote_members_plain` per strand, then
    ``ops.duplex.duplex_vote`` vetoed where a strand is missing (the
    stream twin's "both present" mask; the kernel needs no mask because an
    empty strand votes N)."""
    va = vote_members_plain(bases_a, quals_a, sizes_a, config, length, starts_a)
    vb = vote_members_plain(bases_b, quals_b, sizes_b, config, length, starts_b)
    present = [torch.as_tensor(s).to(va.device) > 0 for s in (sizes_a, sizes_b)]
    dcs_b, dcs_q = duplex_vote(va[0], va[1], vb[0], vb[1], qual_cap=int(config.qual_cap),
                               agree_mask=(present[0] & present[1])[:, None])
    return torch.stack([va[0], va[1], vb[0], vb[1], dcs_b, dcs_q])


# ----------------------------------------------------------------- the card


def _library():
    global _lib
    if _lib is None:
        from consensuscruncher_tpu_torch.ops import cuda_lib

        lib = cuda_lib.load("consensus_vote")
        lib.cct_vote_tiles.restype = ctypes.c_int
        lib.cct_vote_tiles.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.cct_tile_grid.restype = ctypes.c_int
        lib.cct_tile_grid.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.cct_tile_constants.restype = None
        lib.cct_tile_constants.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.cct_error_string.restype = ctypes.c_char_p
        lib.cct_error_string.argtypes = [ctypes.c_int]
        for duplex in (False, True):
            consts = (ctypes.c_int64 * 7)()
            lib.cct_tile_constants(int(duplex), ctypes.addressof(consts))
            if consts[5] != tiles.TILE_COLS:
                raise RuntimeError(f"csrc/consensus_vote.cu's tile table has {consts[5]} "
                                   f"columns, ops/tiles.py's {tiles.TILE_COLS}")
            _layouts[duplex] = tiles.Layout(*consts[:5], stages=consts[6])
        _lib = lib
    return _lib


def _grid(wire: int, duplex: bool, qc: bool, dev: torch.device) -> int:
    """Blocks of the persistent grid of one instantiation on card ``dev``
    (its SM count times the blocks resident per SM), asked of that card."""
    key = (dev.index, wire, int(duplex), int(qc))
    if key not in _grids:
        with torch.cuda.device(dev):
            _grids[key] = _library().cct_tile_grid(*key[1:])
    return _grids[key]


def _book(wire: str, b) -> np.ndarray:
    """The wire's codebook as 16 host bytes (zeros for raw)."""
    book = np.zeros(16, np.uint8)
    if wire != "raw":
        host = torch.as_tensor(b).to("cpu", torch.uint8).numpy().ravel()
        book[:host.size] = host
    return book


def _strand(planes, nplanes, sizes, starts, row_bytes, width, contiguous) -> tuple:
    """A checked strand on the card: its planner view and its two planes
    (the raw wire's bases and quals; a packed wire's rows twice)."""
    ptrs = [p.data_ptr() for p in planes]
    strand = tiles.Strand(starts=starts.numpy(), sizes=sizes.numpy(),
                          row_bytes=int(row_bytes), width=int(width),
                          planes=nplanes, rows=int(planes[0].shape[0]),
                          aligned=all(p % tiles.ALIGN == 0 for p in ptrs),
                          contiguous=contiguous)
    return strand, planes


def _card_strand(bases, quals, sizes, starts, contiguous=None):
    """Checked raw CUDA planes + host ``sizes`` (and ``starts`` or None for
    the exclusive cumsum) -> a strand as :func:`_prepare` takes it;
    ``contiguous`` (default: ``starts`` is None) says each family's rows
    start where the one before it ends."""
    dev = bases.device
    if dev.type != "cuda" or quals.device != dev:
        raise ValueError(f"the vote kernels need CUDA planes on one device, got "
                         f"{bases.device} and {quals.device}")
    if bases.stride(1) != 1 or bases.stride() != quals.stride():
        raise ValueError("member planes must be row-major with matching strides")
    if contiguous is None:
        contiguous = starts is None
    return _strand((bases, quals), 2, sizes, _default_starts(sizes, starts),
                   bases.stride(0), bases.shape[1], contiguous)


def _card_wire(wire, a, b, sizes, starts, contiguous=None):
    """A checked wire batch on the card -> a strand as :func:`_prepare`
    takes it (``starts``, ``contiguous`` as :func:`_card_strand`)."""
    if wire == "raw":
        return _card_strand(a, b, sizes, starts, contiguous)
    if a.device.type != "cuda":
        raise ValueError(f"the vote kernels need CUDA rows, got {a.device}")
    if not a.is_contiguous():
        raise ValueError(f"{wire} rows must be contiguous")
    if contiguous is None:
        contiguous = starts is None
    return _strand((a, a), 1, sizes, _default_starts(sizes, starts), a.shape[1], a.shape[1],
                   contiguous)


class TileLaunch:
    """One planned launch of the vote kernel: the family records (and an
    explicit tile table) on the card, the outputs allocated.  Calling it
    launches the kernel once (counted) and returns ``(planes, stats)``;
    ``plan`` says which path its tiles took; ``qc`` holds the QC rider's
    ``(2, length)`` int32 sums when ``qc_lengths`` was given."""

    def __init__(self, wire, strands, book, config, length, duplex, packed_out,
                 qc_lengths=None):
        # vote.plan: the outputs, the grid, the tile plan with its pinned
        # buffer; vote.launch: the records and their copy, the arguments
        with obs_trace.span("vote.plan"):
            planes = [p for _strand, pl in strands for p in pl]
            if len(strands) == 1:
                planes += planes[:2]
            dev = planes[0].device  # a tensor's device names its card's index
            self.duplex = duplex
            self.wire = WIRES.index(wire)
            n = int(strands[0][0].sizes.shape[0])
            nplanes = (3 if packed_out else 6) if duplex else 2
            self.out = torch.empty((nplanes, n, length), dtype=torch.uint8, device=dev)
            self.with_qc = qc_lengths is not None
            grid = _grid(self.wire, duplex, self.with_qc, dev)  # loads the library and its layout
            # one pinned buffer, one copy to the card: the stats (zeros, which the
            # kernel adds into), with the QC rider its (2, length) int32 sums
            # (zeros), the family records (at an even word: their bulk copies
            # want 16-byte addresses; with the rider each family's length in the
            # high 32 bits of its size), an explicit tile table
            records = n * 2 * len(strands)
            qc_words = length if self.with_qc else 0
            head = 2 + qc_words + qc_words % 2
            pinned = []

            def alloc(k):
                pinned.append(torch.empty(head + k, dtype=torch.int64, pin_memory=True))
                pinned[0][:2 + (length if self.with_qc else 0)] = 0
                return pinned[0][head:].numpy()

            self.plan = tiles.plan_tiles([s for s, _p in strands], length, grid,
                                         _layouts[duplex], alloc)
        with obs_trace.span("vote.launch"):
            host = pinned[0]
            self.n_tiles = self.plan.n_tiles
            self.dev = dev
            if self.n_tiles == 0:
                self.stats = torch.zeros(4, dtype=torch.int32, device=dev)
                self.qc = (torch.zeros((2, length), dtype=torch.int32, device=dev)
                           if self.with_qc else None)
                return
            if self.with_qc:
                self.plan.records[:, 1] |= qc_lengths.numpy().astype(np.int64) << 32
            explicit = self.plan.explicit
            used = head + records + (0 if explicit is None else explicit.size)
            meta = host[:used].to(dev, non_blocking=True)
            obs_metrics.note_transfer("h2d", 8 * used, dev)
            self.stats = meta[:2].view(torch.int32)
            self.qc = meta[2:2 + length].view(torch.int32).view(2, length) if self.with_qc else None
            self._keep = planes
            geometry = [[s.row_bytes, s.width, s.extent] for s, _p in strands]
            geometry *= 3 - len(strands)
            vec = 0
            for i, (s, pl) in enumerate(strands * (3 - len(strands))):
                if (s.width % 4 == 0 and s.row_bytes % 4 == 0
                        and all(p.data_ptr() % 4 == 0 for p in pl)):
                    vec |= 1 << i
            num, den = config.cutoff_rational
            # the C arrays live as long as the launch does
            self._arrays = ((ctypes.c_void_p * 4)(*[p.data_ptr() for p in planes]),
                            *((ctypes.c_int64 * 2)(*[g[k] for g in geometry[:2]])
                              for k in range(3)),
                            (ctypes.c_ubyte * 16)(*book.tolist()))
            ptrs, row_bytes, width, extent, book_c = (ctypes.addressof(a) for a in self._arrays)
            fam = meta.data_ptr() + 8 * head
            self._args = (
                self.wire, int(duplex), ptrs, row_bytes, width, extent, fam,
                None if explicit is None else fam + 8 * records, self.plan.fams, n,
                self.n_tiles, length, num, den, int(config.qual_threshold),
                int(config.qual_cap), book_c, self.out.data_ptr(), n * length,
                self.stats.data_ptr(), int(packed_out), vec,
                self.qc.data_ptr() if self.with_qc else None)

    def __call__(self):
        global launches, qc_launches, fused_launches
        if self.n_tiles == 0:
            return self.out, self.stats
        lib = _library()
        # the planes' card is the current device for the launch, which goes
        # to that card's current stream (a launch on another card's stream,
        # or with another card current, would fail or run on the wrong card)
        with obs_trace.span("vote.launch"), torch.cuda.device(self.dev):
            rc = lib.cct_vote_tiles(*self._args, torch.cuda.current_stream(self.dev).cuda_stream)
        if self.duplex:
            fused_launches += 1
        else:
            launches += 1
            qc_launches += self.with_qc
        if rc != 0:
            raise RuntimeError(f"consensus_vote kernel launch failed: "
                               f"{lib.cct_error_string(rc).decode()}")
        return self.out, self.stats


def _prepare(wire, strands, book, config, length, duplex, packed_out=False,
             qc_lengths=None) -> TileLaunch:
    global last_plan
    job = TileLaunch(wire, strands, book, config, length, duplex, packed_out, qc_lengths)
    last_plan = job.plan
    return job
