"""The majority votes: CUDA kernels, plain PyTorch versions, launch counts.

Two hand-written CUDA kernels in ``csrc/consensus_vote.cu``, sharing one
vote (``csrc/vote_state.cuh``):

- the SSCS vote, port of the TPU kernel ``consensuscruncher_tpu/ops/
  consensus_pallas.py:_vote_kernel`` (:func:`vote_members`);
- the fused duplex vote, port of ``consensus_pallas.py:
  _fused_duplex_kernel``: both strands' SSCS votes and their DCS in one
  launch (:func:`duplex_members`).

Both run over ragged member streams: family ``f``'s members are rows
``starts[f] .. starts[f] + sizes[f] - 1`` of an ``(M, L)`` plane, with
``starts`` the exclusive cumsum of ``sizes`` by default.  The dense
``(B, F, L)`` forms of the TPU kernels are the same streams with
``starts = arange(B) * F`` (:func:`consensus_batch`, :func:`duplex_batch`).

Semantics (reference parity: ``ConsensusCruncher/consensus_helper.py:
consensus_maker``, pinned in ``core/consensus_cpu.py``): low-qual members
vote N; the modal lane wins, ties to the earliest first-seen member; the
vote passes iff ``modal != N and max_count * den >= num * size and size >
0`` in int32; a pass keeps ``min(agreeing qual sum, qual_cap)``, anything
else is ``(N, 0)``.  The duplex combine keeps a base iff both strands voted
it and it is below N, with quality ``min(qa + qb, qual_cap)``.

The wrappers launch the kernel for CUDA tensors (or raise) and run the
plain version only for tensors on the CPU; :func:`launch_kernel` and
:func:`launch_duplex_kernel` are the bare launches on arguments already on
the card.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from consensuscruncher_tpu_torch.core.consensus_cpu import (
    DEFAULT_CUTOFF,
    DEFAULT_QUAL_CAP,
    DEFAULT_QUAL_THRESHOLD,
    cutoff_fraction,
)
from consensuscruncher_tpu_torch.ops.duplex import duplex_vote
from consensuscruncher_tpu_torch.utils.phred import N, NUM_BASES

# Kernel launches made on CUDA tensors since the last reset (one per call of
# a C entry point, which launches its kernel exactly once): the SSCS vote,
# and the fused duplex vote.
launches = 0
fused_launches = 0

_lib = None


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


def _checks(bases, quals, sizes, config, length, starts):
    """Validate a vote's arguments on the host; returns the sizes (int64,
    CPU), the starts (int64, CPU, or None for the exclusive cumsum) and the
    vote length."""
    if bases.dtype != torch.uint8 or quals.dtype != torch.uint8:
        raise TypeError("bases and quals must be uint8")
    if bases.dim() != 2 or bases.shape != quals.shape:
        raise ValueError(f"bases/quals must be matching (M, L) planes, got "
                         f"{tuple(bases.shape)} and {tuple(quals.shape)}")
    length = bases.shape[1] if length is None else int(length)
    if not 0 <= length <= bases.shape[1]:
        raise ValueError(f"length {length} outside [0, {bases.shape[1]}]")
    sizes = sizes.to(device="cpu", dtype=torch.int64)
    if sizes.dim() != 1:
        raise ValueError("sizes must be 1-D")
    if starts is not None:
        starts = starts.to(device="cpu", dtype=torch.int64)
    if sizes.numel():
        if int(sizes.min()) < 0:
            raise ValueError("family sizes must be >= 0")
        if starts is None:
            outside = int(sizes.sum()) > bases.shape[0]
        else:
            outside = (int((starts + sizes).max()) > bases.shape[0]
                       or int(starts.min()) < 0)
        if outside:
            raise ValueError("family rows run outside the member planes")
        config.check_family_size(int(sizes.max()))
    return sizes, starts, length


def _exclusive_cumsum(sizes: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(sizes, 0, dtype=torch.int64) - sizes


def vote_members(bases: torch.Tensor, quals: torch.Tensor, sizes: torch.Tensor,
                 config: ConsensusConfig = ConsensusConfig(),
                 length: int | None = None,
                 starts: torch.Tensor | None = None) -> torch.Tensor:
    """Vote every family of a member stream.

    ``bases``/``quals``: ``(M, L)`` uint8 member planes on one device;
    ``sizes``: ``(NF,)`` family sizes (any device, 0 = empty slot);
    ``length``: vote positions ``[0, length)`` only (default ``L``);
    ``starts``: first row of each family (default: exclusive cumsum of
    ``sizes``, taken on the planes' device).  Returns a stacked
    ``(2, NF, length)`` uint8 tensor (consensus bases, consensus quals) on
    the planes' device; empty slots come back all ``(N, 0)``.
    """
    if bases.device.type == "cpu":
        return vote_members_plain(bases, quals, sizes, config, length, starts)
    sizes, starts, length = _checks(bases, quals, sizes, config, length, starts)
    return _launch(bases, quals, sizes, starts, config, length)


def _library():
    global _lib
    if _lib is None:
        from consensuscruncher_tpu_torch.ops import cuda_lib

        lib = cuda_lib.load("consensus_vote")
        lib.cct_vote_members.restype = ctypes.c_int
        lib.cct_vote_members.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.cct_duplex_members.restype = ctypes.c_int
        lib.cct_duplex_members.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.cct_error_string.restype = ctypes.c_char_p
        lib.cct_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def upload(host: torch.Tensor, dev: torch.device, dtype) -> torch.Tensor:
    """A small host tensor to ``dev`` as ``dtype``; to the card through
    pinned memory, so the copy does not wait for the work already queued on
    the stream (a pageable copy may wait for it)."""
    host = host.to(dtype).contiguous()
    if dev.type == "cpu":
        return host
    return host.pin_memory().to(dev, non_blocking=True)


def _card_strand(bases, quals, sizes, starts):
    """Checked CUDA planes + host ``sizes`` (and ``starts`` or None) ->
    ``(bases, quals, sizes_d, starts_d)`` on the card, where the starts
    default to the exclusive cumsum of the sizes."""
    dev = bases.device
    if dev.type != "cuda" or quals.device != dev:
        raise ValueError(f"the vote kernels need CUDA planes on one device, got "
                         f"{bases.device} and {quals.device}")
    if bases.stride(1) != 1 or bases.stride() != quals.stride():
        raise ValueError("member planes must be row-major with matching strides")
    sizes_d = upload(sizes, dev, torch.int32)
    starts_d = (_exclusive_cumsum(sizes_d) if starts is None
                else upload(starts, dev, torch.int64))
    return bases, quals, sizes_d, starts_d


def _launch(bases, quals, sizes, starts, config, length):
    """Checked host arguments -> the card; then launch the SSCS vote."""
    return launch_kernel(*_card_strand(bases, quals, sizes, starts), config, length)


def launch_kernel(bases, quals, sizes_d, starts_d, config, length):
    """One kernel launch on arguments already checked and on the card:
    ``sizes_d`` int32 and ``starts_d`` int64, both ``(NF,)``."""
    global launches
    nf = sizes_d.shape[0]
    dev = bases.device
    out = torch.empty((2, nf, length), dtype=torch.uint8, device=dev)
    if nf == 0 or length == 0:
        return out
    num, den = config.cutoff_rational
    lib = _library()
    rc = lib.cct_vote_members(
        bases.data_ptr(), quals.data_ptr(), starts_d.data_ptr(),
        sizes_d.data_ptr(), nf, length, bases.stride(0), num, den,
        int(config.qual_threshold), int(config.qual_cap),
        out[0].data_ptr(), out[1].data_ptr(), length,
        torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    if rc != 0:
        raise RuntimeError(f"consensus_vote kernel launch failed: "
                           f"{lib.cct_error_string(rc).decode()}")
    return out


def vote_members_plain(bases, quals, sizes, config: ConsensusConfig = ConsensusConfig(),
                       length: int | None = None, starts=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: gather each family
    into a dense ``(NF, cap, length)`` block (``cap`` = largest family)
    and reduce over the member axis, lane by lane — the kernel's state
    machine written as tensor ops."""
    sizes, starts, length = _checks(bases, quals, sizes, config, length, starts)
    dev = bases.device
    nf = sizes.shape[0]
    out = torch.empty((2, nf, length), dtype=torch.uint8, device=dev)
    out[0].fill_(N)
    out[1].zero_()
    if nf == 0 or length == 0 or bases.shape[0] == 0:
        return out
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
    return out


def consensus_batch(bases: torch.Tensor, quals: torch.Tensor, fam_sizes,
                    config: ConsensusConfig = ConsensusConfig()):
    """Dense form, the port of ``consensus_batch_pallas``: ``(B, F, L)``
    uint8 planes + ``(B,)`` sizes -> ``(out_b, out_q)`` ``(B, L)`` uint8.
    Member slots ``>= size`` are never read.  Same kernel, with family ``i``
    at rows ``i * F ..`` of the flattened ``(B * F, L)`` stream."""
    b, f, length = bases.shape
    sizes = torch.as_tensor(fam_sizes).to(device="cpu", dtype=torch.int64)
    starts = torch.arange(b, dtype=torch.int64) * f
    if sizes.numel() and int(sizes.max()) > f:
        raise ValueError(f"family size exceeds the member capacity {f}")
    out = vote_members(bases.reshape(b * f, length), quals.reshape(b * f, length),
                       sizes, config, starts=starts)
    return out[0], out[1]


# ------------------------------------------------------- fused duplex vote


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


def duplex_members(bases_a: torch.Tensor, quals_a: torch.Tensor, sizes_a,
                   bases_b: torch.Tensor, quals_b: torch.Tensor, sizes_b,
                   config: ConsensusConfig = ConsensusConfig(),
                   length: int | None = None,
                   starts_a: torch.Tensor | None = None,
                   starts_b: torch.Tensor | None = None) -> torch.Tensor:
    """Fused SSCS + DCS vote of ``P`` strand pairs.

    Each strand is a member stream as :func:`vote_members` takes it
    (``(M, L)`` uint8 planes, ``(P,)`` sizes, optional starts); pair ``p``
    is family ``p`` of strand A with family ``p`` of strand B.  The stream
    form passes one member stream as both strands, with ``starts_a`` and
    ``starts_b`` picking its A and B families.  Returns a stacked
    ``(6, P, length)`` uint8 tensor on the planes' device: SSCS-a bases,
    SSCS-a quals, SSCS-b bases, SSCS-b quals, DCS bases, DCS quals.
    """
    strand_a, strand_b, length = _duplex_checks(
        (bases_a, quals_a, sizes_a, starts_a), (bases_b, quals_b, sizes_b, starts_b),
        config, length)
    if bases_a.device.type == "cpu":
        return duplex_members_plain(*strand_a[:3], *strand_b[:3], config, length,
                                    strand_a[3], strand_b[3])
    return launch_duplex_kernel(*_card_strand(*strand_a), *_card_strand(*strand_b),
                                config, length)


def launch_duplex_kernel(bases_a, quals_a, sizes_a_d, starts_a_d,
                         bases_b, quals_b, sizes_b_d, starts_b_d, config, length):
    """One fused kernel launch on arguments already checked and on the
    card: per strand int32 sizes and int64 starts, both ``(P,)``."""
    global fused_launches
    n = sizes_a_d.shape[0]
    out = torch.empty((6, n, length), dtype=torch.uint8, device=bases_a.device)
    if n == 0 or length == 0:
        return out
    num, den = config.cutoff_rational
    lib = _library()
    rc = lib.cct_duplex_members(
        bases_a.data_ptr(), quals_a.data_ptr(), starts_a_d.data_ptr(),
        sizes_a_d.data_ptr(), bases_a.stride(0),
        bases_b.data_ptr(), quals_b.data_ptr(), starts_b_d.data_ptr(),
        sizes_b_d.data_ptr(), bases_b.stride(0),
        n, length, num, den, int(config.qual_threshold), int(config.qual_cap),
        out.data_ptr(), length, n * length,
        torch.cuda.current_stream(bases_a.device).cuda_stream)
    fused_launches += 1
    if rc != 0:
        raise RuntimeError(f"duplex_members kernel launch failed: "
                           f"{lib.cct_error_string(rc).decode()}")
    return out


def duplex_members_plain(bases_a, quals_a, sizes_a, bases_b, quals_b, sizes_b,
                         config: ConsensusConfig = ConsensusConfig(),
                         length: int | None = None, starts_a=None,
                         starts_b=None) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel on any device: the unfused
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


def duplex_batch(bases_a: torch.Tensor, quals_a: torch.Tensor, sizes_a,
                 bases_b: torch.Tensor, quals_b: torch.Tensor, sizes_b,
                 config: ConsensusConfig = ConsensusConfig()):
    """Dense form, the port of ``duplex_batch_pallas``: two ``(B, F, L)``
    uint8 strand batches (pairs aligned on the batch axis) + ``(B,)`` sizes
    each -> the six ``(B, L)`` uint8 planes ``(sscs_a_b, sscs_a_q,
    sscs_b_b, sscs_b_q, dcs_b, dcs_q)``.  Member slots ``>= size`` are
    never read; no family-major transpose and no batch padding."""
    if not bases_a.shape == quals_a.shape == bases_b.shape == quals_b.shape:
        raise ValueError(f"strand batches must share a shape, got "
                         f"{tuple(bases_a.shape)} vs {tuple(bases_b.shape)}")
    b, f, length = bases_a.shape
    config.check_family_size(f)  # the int32 cutoff guard, as the TPU wrapper's
    sizes = [torch.as_tensor(s).to(device="cpu", dtype=torch.int64)
             for s in (sizes_a, sizes_b)]
    if any(s.numel() and int(s.max()) > f for s in sizes):
        raise ValueError(f"family size exceeds the member capacity {f}")
    starts = torch.arange(b, dtype=torch.int64) * f
    out = duplex_members(bases_a.reshape(b * f, length), quals_a.reshape(b * f, length),
                         sizes[0], bases_b.reshape(b * f, length),
                         quals_b.reshape(b * f, length), sizes[1], config,
                         starts_a=starts, starts_b=starts)
    return tuple(out)
