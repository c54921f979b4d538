"""Member-stream votes: wire encode on the host, decode + vote on the card.

Port of the stream-wire half of ``consensuscruncher_tpu/ops/
consensus_segment.py``.  A batch's families ship as a flat ``(M, L)``
member stream (every real read exactly once, packed per
:func:`encode_member_batch`) plus per-family ``sizes``; the CUDA kernels
of ``ops.consensus_vote`` decode the wire and vote every family in one
launch (their plain versions, after ``ops.packing.unpack_wire``, on the
CPU).  The kernels handle any family size, so the JAX package's
segment-scatter fallback for families over 512 members has no counterpart
here.  A vote policy other than majority (``policies/``) votes as the JAX
package's gather path does: the wire decoded by ``unpack_wire``, each
family gathered into a dense ``(NF, cap, L)`` block and voted by torch
ops on the wire's device; a batch with a family over ``MAX_DENSE_CAP``
members is refused, as the reference refuses it.

Users: the SSCS stage (:func:`consensus_blocks_stream_batched`, the
SSCS vote); the library's member-stream entries
(:func:`consensus_families_stream` over ragged families,
:func:`consensus_blocks_stream` over family blocks: the same batches, one
B1 launch each on the card, yielded per family); and the fused SSCS+DCS API (:func:`segment_duplex_step`,
:func:`run_duplex_pipelined`, the fused duplex vote), whose member stream
holds strand A's families in slots ``0..n-1`` and strand B's in
``n..2n-1``.
"""

from __future__ import annotations

import numpy as np
import torch

from consensuscruncher_tpu_torch.device import resolve_device
from consensuscruncher_tpu_torch.io import native
from consensuscruncher_tpu_torch.obs import metrics as obs_metrics
from consensuscruncher_tpu_torch.ops import consensus_vote
from consensuscruncher_tpu_torch.ops.consensus_vote import ConsensusConfig
from consensuscruncher_tpu_torch.ops.packing import (
    CODEBOOK4_SIZE,
    CODEBOOK_SIZE,
    _qual_lut,
    build_codebook,
    build_codebook4,
    pack,
    pack4,
    pack6,
    unpack_wire,
)
from consensuscruncher_tpu_torch.parallel import mesh as mesh_mod
from consensuscruncher_tpu_torch.parallel.batching import (
    QUAL_FILL_SENTINEL,
    bucket_member_blocks,
    bucket_members,
)
from consensuscruncher_tpu_torch.policies import DEFAULT_POLICY, get_policy
from consensuscruncher_tpu_torch.utils.phred import N, NUM_BASES  # noqa: F401
from consensuscruncher_tpu_torch.utils import sanitize


def derive_ids_device(sizes: torch.Tensor, total_members: int):
    """``(fam_ids, ranks)`` int32 tensors of a member stream from its
    per-family ``sizes``, on their device: member ``m`` belongs to family
    ``fam_ids[m]`` and is its ``ranks[m]``-th member.  ``total_members``
    must be ``sizes.sum()`` (the stream's length)."""
    sizes = sizes.to(torch.int32)
    nf = sizes.shape[0]
    fam_ids = torch.repeat_interleave(
        torch.arange(nf, dtype=torch.int32, device=sizes.device), sizes,
        output_size=total_members)
    starts = torch.cumsum(sizes, 0, dtype=torch.int32) - sizes
    ranks = (torch.arange(total_members, dtype=torch.int32, device=sizes.device)
             - starts[fam_ids.long()])
    return fam_ids, ranks


def encode_member_batch(batch):
    """Host-side wire encode of a ``parallel.batching.MemberBatch``.

    Picks the densest wire the batch admits — pack4 (pure-ACGT live bases,
    <=4 distinct live quals), pack6 (pure-ACGT, 5..16 distinct quals),
    pack8 (<=16 distinct quals, Ns allowed), else raw — and rewrites dead
    cells (qual sentinel) to codebook-legal values (their content never
    reaches a live output; see the MemberBatch docstring).  Returns
    ``(wire, a, b)``: raw = (bases, quals); packed = (packed, codebook).
    """
    rows, qrows = batch.rows, batch.qrows
    if native.available():
        # one-pass byte histogram (np.unique sorts the whole batch)
        uniq = np.nonzero(native.byte_counts(qrows))[0].astype(np.uint8)
        present = np.nonzero(native.byte_counts(rows))[0]
        base_max = int(present[-1]) if present.size else 0
    else:
        uniq = np.unique(qrows)
        base_max = int(rows.max(initial=0))
    uniq = uniq[uniq != QUAL_FILL_SENTINEL]

    def packed_wire(book, four_bit):
        # Dead cells hold QUAL_FILL_SENTINEL (255, never a live Phred);
        # mapping it to codebook slot 0 in the LUT packs them as
        # (base, book[0]) in the same pass.
        if native.available():
            lut = _qual_lut(book)
            lut[QUAL_FILL_SENTINEL] = 0
            return native.pack_wire(rows, qrows, lut, four_bit=four_bit)
        qf = np.where(qrows == QUAL_FILL_SENTINEL, book[0], qrows)
        return pack4(rows, qf, book) if four_bit else pack(rows, qf, book)

    if base_max < 4 and 0 < uniq.size <= CODEBOOK4_SIZE:
        book = build_codebook4(uniq)
        return "pack4", packed_wire(book, True), book
    if base_max < 4 and 0 < uniq.size <= CODEBOOK_SIZE:
        book = build_codebook(uniq)
        lut = _qual_lut(book)
        lut[QUAL_FILL_SENTINEL] = 0  # dead cells -> slot 0, never read live
        return "pack6", pack6(rows, qrows, book, qual_lut=lut), book
    if uniq.size <= CODEBOOK_SIZE:
        book = build_codebook(uniq if uniq.size else np.zeros(1, np.uint8))
        return "pack8", packed_wire(book, False), book
    qf = np.where(qrows == QUAL_FILL_SENTINEL, 0, qrows).astype(np.uint8)
    return "raw", rows, qf


def stream_vote(wire: str, a: torch.Tensor, b: torch.Tensor, sizes,
                config: ConsensusConfig = ConsensusConfig(),
                out_len: int | None = None, qc_lengths=None, policy=DEFAULT_POLICY):
    """The port of ``_stream_vote_fn``: decode the wire, vote every family.
    Returns the stacked ``(2, NF, out_len)`` uint8 planes (consensus bases,
    quals) on the wire's device; ``out_len=None`` keeps every position.  A
    packed wire's codebook ``b`` may stay on the host.  ``qc_lengths``
    (each family's true length) adds the QC rider, ``with_qc``: returns
    ``(planes, qc)``, ``qc`` the ``(2, out_len)`` int32 sums of votes and of
    votes disagreeing with the modal base over the families, at positions
    below their lengths.

    ``policy`` (a name or a ``policies.VotePolicy``): majority, the default,
    is one launch of the SSCS kernel (``consensus_vote.vote_wire``); any
    other policy votes by :func:`policy_stream_vote`."""
    policy = get_policy(policy)
    if policy.name == DEFAULT_POLICY:
        return consensus_vote.vote_wire(wire, a, b, torch.as_tensor(sizes), config,
                                        length=out_len, qc_lengths=qc_lengths)
    return policy_stream_vote(policy, wire, a, b, sizes, config, out_len, qc_lengths)


def policy_stream_vote(policy, wire, a, b, sizes, config: ConsensusConfig = ConsensusConfig(),
                       out_len=None, qc_lengths=None):
    """A non-majority policy's stream vote, the port of the JAX package's
    ``_gather_dense_vote`` under ``_stream_vote_fn``: decode the wire
    (``unpack_wire``), gather family ``f``'s rows into slots ``0 ..
    sizes[f] - 1`` of an ``(NF, cap, out_len)`` block (``cap`` =
    :func:`pick_member_cap`; dead slots gather row 0 and are no members)
    and vote it with ``policy.family_vote_fn``, all on the wire's device.
    Returns as :func:`stream_vote`; the QC rider sums the policy-independent
    per-family votes and disagreements at positions below each family's
    length.  A batch whose largest family exceeds :data:`MAX_DENSE_CAP`
    raises the reference's ``ValueError``."""
    sizes, _starts, length, qc_lengths = consensus_vote._wire_checks(
        wire, a, b, sizes, config, out_len, None, qc_lengths)
    cap = pick_member_cap(sizes.numpy())
    if cap is None:
        raise ValueError(
            f"vote policy {policy.name!r} requires the gather path (a family "
            f"exceeded MAX_DENSE_CAP={MAX_DENSE_CAP} members); only the "
            "majority default supports the segment-scatter fallback")
    dev = a.device
    bases, quals = unpack_wire(wire, a, torch.as_tensor(b).to(dev))
    if bases.shape[0] == 0:  # no members: one dead row for the empty slots' gather
        bases = quals = torch.zeros((1, bases.shape[1]), dtype=torch.uint8, device=dev)
    sizes = sizes.to(dev)
    slot = torch.arange(cap, device=dev)
    rows = torch.where(slot < sizes[:, None],
                       consensus_vote._exclusive_cumsum(sizes)[:, None] + slot, 0)
    num, den = config.cutoff_rational
    vote = policy.family_vote_fn(num=num, den=den, qual_threshold=int(config.qual_threshold),
                                 qual_cap=int(config.qual_cap),
                                 with_qc=qc_lengths is not None)
    out = vote(bases[:, :length][rows], quals[:, :length][rows], sizes)
    planes = torch.stack(out[:2])
    if qc_lengths is None:
        return planes
    live = torch.arange(length, device=dev) < qc_lengths.to(dev)[:, None]
    qc = torch.stack([torch.where(live, out[2], 0).sum(0, dtype=torch.int32),
                      torch.where(live, out[3], 0).sum(0, dtype=torch.int32)])
    return planes, qc


def _out_len(batch) -> int | None:
    # the JAX package's d2h slice length: longest family, rounded up to 8
    out_len = int(batch.lengths.max(initial=0))
    return -(-out_len // 8) * 8 or None


def _run_member_batch_stream(batches, config: ConsensusConfig, device: torch.device,
                             on_device_batch=None, policy=DEFAULT_POLICY, mesh=None):
    """MemberBatch iterable -> one ``(keys, lengths, out_bases, out_quals)``
    host tuple per batch (the ``(n_real, out_len)`` result planes; callers
    slice rows by ``lengths``).  Serial: encode, upload, vote, download.
    Only the ``n_real`` live families are voted, not the zero-size slots
    that pad the batch's family count to a power of two (the JAX
    package's shape buckets; the port compiles nothing per shape).

    ``on_device_batch(batch, planes)`` is called with the stacked
    ``(2, n_real, out_len)`` vote output while it is still on ``device``,
    before the download: the residency capture point (``ops.residency``).

    While an ``obs.qc`` plane sink is armed, every vote carries the QC
    rider over the batch's true lengths, and its ``(2, out_len)`` sums are
    added on ``device`` into one int64 ``(2, longest out_len)`` total (no
    wait per batch, and no batch's buffers kept alive); the total goes to
    the sink as one handle when the batches end, and the sink copies it to
    the host when it is finalized.

    ``policy``: the vote policy of every batch (see :func:`stream_vote`).

    ``mesh``: a ``parallel.mesh.Mesh`` to family-shard each batch over
    (``parallel.mesh.stream_vote_sharded``: the batch's live families
    planned into contiguous runs, one launch per device; rows return to
    key order by ``plan.order()``); None = ``device`` alone.  As in the JAX
    package, a mesh takes the majority vote only (any other policy
    raises), arms no QC rider (its rows come back in per-device blocks)
    and fires no ``on_device_batch``."""
    from consensuscruncher_tpu_torch.obs import qc as obs_qc

    name = get_policy(policy).name
    if mesh is not None and name != DEFAULT_POLICY:
        raise ValueError(f"vote policy {name!r} is single-device only — the mesh stream "
                         "wire shards the hand-unrolled majority program")
    qc_sink = obs_qc.plane_sink() if mesh is None else None
    qc_total = torch.zeros((2, 0), dtype=torch.int64, device=device)
    try:
        for batch in batches:
            wire, a, b = encode_member_batch(batch)
            n = batch.n_real
            # under CCT_SANITIZE (utils.sanitize.guarded_stage) the batch's
            # upload with its launch, and the planes' download, are the
            # stage's sanctioned transfers; the encode, the residency hook
            # and the QC sums run guarded
            if mesh is not None:  # each shard's upload is counted where it is made
                sizes = batch.sizes[:n]
                order = mesh_mod.plan_member_shards(sizes, mesh.size).order()
                with sanitize.allow_transfer("sharded stream batch upload and vote"):
                    planes = mesh_mod.stream_vote_sharded(mesh, wire, a, b, sizes, config,
                                                          _out_len(batch))
                    planes = planes[:, torch.from_numpy(order).to(planes.device)]
            else:
                obs_metrics.note_transfer("h2d", a.nbytes + (b.nbytes if wire == "raw" else 0),
                                          device)
                # the codebook of a packed wire rides in the kernel's arguments
                b = torch.from_numpy(b)
                lengths = None if qc_sink is None else torch.from_numpy(batch.lengths[:n])
                with sanitize.allow_transfer("stream batch upload and vote"):
                    planes = stream_vote(wire, torch.from_numpy(a).to(device),
                                         b.to(device) if wire == "raw" else b,
                                         torch.from_numpy(batch.sizes[:n]), config,
                                         _out_len(batch), lengths, policy)
                if qc_sink is not None:
                    planes, qc = planes
                    qc_total = _add_qc(qc_total, qc)
                if on_device_batch is not None:
                    on_device_batch(batch, planes)
            with sanitize.allow_transfer("stream batch download"):
                out = planes.cpu().numpy()
            obs_metrics.note_transfer("d2h", out.nbytes, device)
            yield batch.keys, batch.lengths[:n].astype(np.int64), out[0], out[1]
    finally:
        if qc_sink is not None and qc_total.shape[1]:
            qc_sink.add_plane_handle(qc_total)


def _add_qc(total: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
    """``total`` (int64 ``(2, T)``) plus one batch's ``(2, L)`` QC sums,
    zero-padded to the longer of the two; queued on their device."""
    if qc.shape[1] > total.shape[1]:
        total = torch.nn.functional.pad(total, (0, qc.shape[1] - total.shape[1]))
    total[:, :qc.shape[1]] += qc
    return total


def consensus_blocks_stream_batched(items, config: ConsensusConfig,
                                    device: torch.device, on_device_batch=None,
                                    policy=DEFAULT_POLICY, mesh=None):
    """FamilyBlock items ``(block, fam_idx, keys)`` (see
    ``parallel.batching.bucket_member_blocks``) -> per-batch
    ``(keys, lengths, out_bases, out_quals)`` tuples, voted on ``device``
    (or family-sharded over ``mesh``) under ``policy``;
    ``on_device_batch`` is the residency capture hook (see
    :func:`_run_member_batch_stream`)."""
    yield from _run_member_batch_stream(bucket_member_blocks(items), config, device,
                                        on_device_batch, policy, mesh)


def _per_family(batched):
    """Per-batch ``(keys, lengths, out_bases, out_quals)`` -> per-family
    ``(key, consensus_base, consensus_qual)``, sliced to true length."""
    for keys, lengths, out_b, out_q in batched:
        for i, key in enumerate(keys):
            length = int(lengths[i])
            yield key, out_b[i, :length], out_q[i, :length]


def consensus_families_stream(families, config: ConsensusConfig, device: torch.device,
                              max_batch: int = 4096, member_limit: int = 32768,
                              policy=DEFAULT_POLICY):
    """Member-stream twin of ``ops.consensus_dense.consensus_families``.

    Consumes ``(key, member_seqs, member_quals)`` (ragged lists of 1-D
    uint8 arrays), batched by ``parallel.batching.bucket_members``; yields
    ``(key, consensus_base, consensus_qual)`` sliced to true length, in
    batch order, each batch one vote on ``device`` (on the card, one B1
    launch) under ``policy``.  Bit-identical to the dense wire's outputs."""
    yield from _per_family(_run_member_batch_stream(
        bucket_members(families, max_batch=max_batch, member_limit=member_limit),
        config, device, policy=policy))


def consensus_blocks_stream(items, config: ConsensusConfig, device: torch.device,
                            max_batch: int = 4096, member_limit: int = 32768,
                            policy=DEFAULT_POLICY):
    """FamilyBlock twin of :func:`consensus_families_stream`: ``items``
    yields ``(block, fam_idx, keys)`` (see
    ``parallel.batching.bucket_member_blocks``); yields the same per-family
    ``(key, consensus_base, consensus_qual)`` stream, bit-identical."""
    yield from _per_family(_run_member_batch_stream(
        bucket_member_blocks(items, max_batch=max_batch, member_limit=member_limit),
        config, device, policy=policy))


# ------------------------------------------------- fused SSCS + DCS (B9)


def build_member_stream(size_arrays: list[np.ndarray]):
    """Host-side prep: per-family sizes -> (fam_ids, ranks, sizes) for the
    slot layout ``concatenate(size_arrays)`` (strand A slots then strand B).

    Returns int32 arrays; total members M = sizes.sum().  The member rows
    themselves must be stacked by the caller in the same order (all of
    family 0's reads, then family 1's, ...).
    """
    sizes = np.concatenate([np.asarray(s, dtype=np.int32) for s in size_arrays])
    fam_ids = np.repeat(np.arange(sizes.size, dtype=np.int32), sizes)
    # rank within family: global arange minus each family's start offset
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    ranks = np.arange(fam_ids.size, dtype=np.int32) - starts[fam_ids]
    return fam_ids, ranks, sizes


# The JAX package's largest gather-to-dense member capacity: the gather
# block of a non-majority policy's stream vote (the majority kernels take
# any family size, and there a capacity only validates).
MAX_DENSE_CAP = 512


def pick_member_cap(sizes: np.ndarray) -> int | None:
    """Next power of two >= the largest family size, or None past
    :data:`MAX_DENSE_CAP` (the JAX package's segment-fallback signal)."""
    max_size = int(np.max(sizes, initial=1))
    if max_size > MAX_DENSE_CAP:
        return None
    return 1 << max(0, (max_size - 1).bit_length())


def segment_duplex_step(num_pairs: int, length: int,
                        config: ConsensusConfig = ConsensusConfig(),
                        packed_out: bool = False,
                        member_cap: int | None = None):
    """The port of ``_compiled_segment_duplex``: a callable
    ``(packed, sizes, codebook4)`` that votes both strands of a pack4 member
    stream and their DCS, stats included, with one launch of the fused
    kernel (which decodes the wire itself); on the card the step is the
    checks, the tile plan, one upload of the sizes and tiles, the
    allocations and that launch.

    Family slots: strand A of pair ``i`` is slot ``i``, strand B slot
    ``num_pairs + i`` (size 0 = absent strand); the starts are the
    exclusive cumsum of the ``2 * num_pairs`` sizes, so rows past
    ``sizes.sum()`` (member-axis padding) are never read.  ``sizes`` and
    ``codebook4`` may lie on any device; the checks read them on the host
    (a host codebook spares a device sync).  Returns, on
    ``packed``'s device, ``(sscs_a, qa, sscs_b, qb, dcs, dq, stats)``, or
    with ``packed_out`` ``(sscs_a | sscs_b << 3, qa, qb, stats)`` — the DCS
    is then derived on the host (:func:`derive_host_outputs`).  ``stats`` is
    ``[real, duplexes, n_count, q_sum]`` int32.  ``member_cap`` only
    validates: a family larger than it raises.
    """
    def step(packed, sizes, codebook4):
        sizes = torch.as_tensor(sizes).to(device="cpu", dtype=torch.int64)
        if sizes.shape != (2 * num_pairs,):
            raise ValueError(f"expected {2 * num_pairs} family sizes, got "
                             f"{tuple(sizes.shape)}")
        if member_cap is not None and sizes.numel() and int(sizes.max()) > member_cap:
            raise ValueError(f"member_cap={member_cap} < max family size "
                             f"{int(sizes.max())}")
        if 2 * packed.shape[-1] < length:
            raise ValueError(f"pack4 rows of {packed.shape[-1]} bytes hold fewer "
                             f"than {length} positions")
        out, stats = consensus_vote.duplex_wire("pack4", packed, codebook4, sizes,
                                                config, length, packed_out=packed_out)
        return (*out, stats)

    return step


def derive_host_outputs(packed_bases, qa, qb, sizes_a, sizes_b,
                        config: ConsensusConfig = ConsensusConfig()):
    """Host-side inverse of ``packed_out=True``: unpack SSCS bases and
    re-derive the DCS exactly as the device's duplex combine does (the DCS
    is a pure elementwise function of the SSCS pair).

    ``config`` must be the SAME ConsensusConfig the step was built with —
    the qual cap feeds the duplex quality sum.

    Returns ``(sscs_a, qa, sscs_b, qb, dcs, dq)`` uint8 arrays.
    """
    qual_cap = int(config.qual_cap)
    packed_bases = np.asarray(packed_bases, dtype=np.uint8)
    qa = np.asarray(qa, dtype=np.uint8)
    qb = np.asarray(qb, dtype=np.uint8)
    sscs_a = packed_bases & 7
    sscs_b = packed_bases >> 3
    both = (np.asarray(sizes_a) > 0) & (np.asarray(sizes_b) > 0)
    agree = (sscs_a == sscs_b) & (sscs_a < N) & both[:, None]
    dcs = np.where(agree, sscs_a, np.uint8(N)).astype(np.uint8)
    qsum = qa.astype(np.int32) + qb.astype(np.int32)
    dq = np.where(agree, np.minimum(qsum, qual_cap), 0).astype(np.uint8)
    return sscs_a, qa, sscs_b, qb, dcs, dq


def run_duplex_pipelined(rows, qrows, sizes_a, sizes_b, codebook4,
                         config: ConsensusConfig = ConsensusConfig(), *,
                         chunk_pairs: int = 4096,
                         member_bucket: int = 32768,
                         member_cap: int | None | str = "auto",
                         device: torch.device | str | None = None):
    """Chunked, double-buffered host-to-host SSCS+DCS over the member-stream
    wire (port of the JAX package's ``run_duplex_pipelined``).

    ``rows``/``qrows`` are the ``(M, L)`` member stream ordered by family
    slot, strand A slots ``0..n-1`` then strand B slots (the
    :func:`build_member_stream` layout); ``sizes_a``/``sizes_b`` the
    per-pair strand family sizes.  Each chunk of ``chunk_pairs`` pairs is
    padded to ``chunk_pairs`` slots (size-0 dummies) and its member axis to
    a multiple of ``member_bucket`` (unreferenced rows, quals
    ``codebook4[0]``), pack4-encoded on a background thread, uploaded
    through pinned memory and voted by :func:`segment_duplex_step`; its
    outputs come back through pinned buffers behind an event
    (``parallel.prefetch.start_fetch``), so chunk *k*'s download waits only
    for chunk *k*, after chunk *k+1* is queued.  ``device`` defaults to the
    card.

    Returns ``(sscs_a, qa, sscs_b, qb, dcs, dq, stats)`` host arrays —
    bit-identical to the single-shot step on the same inputs.
    """
    from consensuscruncher_tpu_torch.parallel.prefetch import pipelined, prefetch, start_fetch

    dev = resolve_device(device)
    rows = np.asarray(rows, dtype=np.uint8)
    qrows = np.asarray(qrows, dtype=np.uint8)
    sizes_a = np.asarray(sizes_a, dtype=np.int32)
    sizes_b = np.asarray(sizes_b, dtype=np.int32)
    codebook4 = np.asarray(codebook4, dtype=np.uint8)
    n_pairs = sizes_a.shape[0]
    length = rows.shape[1]
    if member_cap == "auto":
        member_cap = pick_member_cap(np.concatenate([sizes_a, sizes_b]))
    max_size = int(max(sizes_a.max(initial=0), sizes_b.max(initial=0)))
    if member_cap is not None and max_size > member_cap:
        raise ValueError(
            f"member_cap={member_cap} < max family size {max_size} — "
            "raise the cap or pass member_cap=None")

    ends_a = np.cumsum(sizes_a, dtype=np.int64)
    starts_a = ends_a - sizes_a
    a_total = int(ends_a[-1]) if n_pairs else 0
    ends_b = np.cumsum(sizes_b, dtype=np.int64) + a_total
    starts_b = ends_b - sizes_b

    step = segment_duplex_step(chunk_pairs, length, config, packed_out=True,
                               member_cap=member_cap)
    book = torch.from_numpy(codebook4)  # host: the kernel takes it by value
    pinned = dev.type == "cuda"

    def batches():  # runs on the prefetch thread: numpy and pinning only
        for i0 in range(0, n_pairs, chunk_pairs):
            i1 = min(i0 + chunk_pairs, n_pairs)
            a0, a1 = int(starts_a[i0]), int(ends_a[i1 - 1])
            b0, b1 = int(starts_b[i0]), int(ends_b[i1 - 1])
            chunk_rows = np.concatenate([rows[a0:a1], rows[b0:b1]])
            chunk_qrows = np.concatenate([qrows[a0:a1], qrows[b0:b1]])
            m = chunk_rows.shape[0]
            m_pad = max(member_bucket, -(-m // member_bucket) * member_bucket)
            if m_pad != m:
                pad = ((0, m_pad - m), (0, 0))
                chunk_rows = np.pad(chunk_rows, pad)
                chunk_qrows = np.pad(chunk_qrows, pad, constant_values=codebook4[0])
            sizes = np.zeros(2 * chunk_pairs, np.int32)
            sizes[: i1 - i0] = sizes_a[i0:i1]
            sizes[chunk_pairs: chunk_pairs + (i1 - i0)] = sizes_b[i0:i1]
            packed = torch.from_numpy(pack4(chunk_rows, chunk_qrows, codebook4))
            yield i0, i1, packed.pin_memory() if pinned else packed, sizes

    def dispatch(batch):
        _i0, _i1, packed, sizes = batch
        outs = step(packed.to(dev, non_blocking=True), sizes, book)
        return start_fetch(*outs)

    out_a = np.empty((n_pairs, length), np.uint8)
    out_qa = np.empty((n_pairs, length), np.uint8)
    out_b = np.empty((n_pairs, length), np.uint8)
    out_qb = np.empty((n_pairs, length), np.uint8)
    out_d = np.empty((n_pairs, length), np.uint8)
    out_dq = np.empty((n_pairs, length), np.uint8)
    stats = np.zeros(4, np.int64)

    def fetch(batch, pending):
        i0, i1, _packed, _sizes = batch
        pk, qa, qb, st = pending.result()
        k = i1 - i0
        sa, qa_, sb, qb_, dcs, dq = derive_host_outputs(
            pk[:k], qa[:k], qb[:k], sizes_a[i0:i1], sizes_b[i0:i1], config)
        out_a[i0:i1], out_qa[i0:i1] = sa, qa_
        out_b[i0:i1], out_qb[i0:i1] = sb, qb_
        out_d[i0:i1], out_dq[i0:i1] = dcs, dq
        stats[:] += st
        yield None

    stream = prefetch(batches())
    try:
        for _ in pipelined(stream, dispatch, fetch):
            pass
    finally:
        stream.close()
    return out_a, out_qa, out_b, out_qb, out_d, out_dq, stats
