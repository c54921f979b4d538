"""The dense wire (``--wire dense``): padded ``(B, F, L)`` family batches.

Port of the dense half of ``consensuscruncher_tpu/ops/consensus_tpu.py``
(``consensus_batch``, ``consensus_families``).  Ragged families bucket into
``parallel.batching.FamilyBatch``es on a producer thread; each batch's live
families upload as their ``(n, F, L)`` slots and vote in one launch of B1's
dense form (``ops.consensus_vote.consensus_batch``: family ``i`` at rows
``i * F ..`` of the member stream), with one batch in flight while the
previous one downloads.  The JAX CLI's dense wire runs the XLA program
``majority_family_vote`` under ``vmap`` here; B1's dense form computes the
same function.  Each dispatch is a ``device.dispatch`` trace span whose
wall feeds the ``device_dispatch_s`` histogram, as in the JAX package.
Under a vote policy other than majority each batch votes
by the policy (``consensus_vote.consensus_batch(..., policy=)``).

The library's batch calls are here too: :func:`consensus_batch_host`
votes a whole padded batch on a device and returns host arrays, and
:func:`qc_member_reduction` is the QC reduction over family-major member
planes, as torch ops on their device.

While an ``obs.qc`` plane sink is armed, every batch carries the dense
rider (see ``consensus_vote.consensus_batch``: every position of the
padded width, no length mask), summed on the device into one int64 total
that goes to the sink as one handle when the batches end.
"""

from __future__ import annotations

import numpy as np
import torch

from consensuscruncher_tpu_torch.core.consensus_cpu import (  # noqa: F401 (the reference's names)
    DEFAULT_CUTOFF,
    DEFAULT_QUAL_CAP,
    DEFAULT_QUAL_THRESHOLD,
)
from consensuscruncher_tpu_torch.obs import metrics as obs_metrics
from consensuscruncher_tpu_torch.obs import qc as obs_qc
from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.ops import consensus_vote
from consensuscruncher_tpu_torch.ops.consensus_segment import _add_qc
from consensuscruncher_tpu_torch.ops.consensus_vote import ConsensusConfig
from consensuscruncher_tpu_torch.parallel import mesh as mesh_mod
from consensuscruncher_tpu_torch.parallel.batching import FamilyBatch, bucket_families
from consensuscruncher_tpu_torch.parallel.prefetch import (
    DEFAULT_DEPTH,
    pipelined,
    prefetch,
    start_fetch,
)
from consensuscruncher_tpu_torch.policies import DEFAULT_POLICY, get_policy
from consensuscruncher_tpu_torch.utils import sanitize
from consensuscruncher_tpu_torch.utils.phred import N, NUM_BASES, PAD


def consensus_batch(batch: FamilyBatch, config: ConsensusConfig, device: torch.device,
                    qc: bool = False, policy=DEFAULT_POLICY):
    """Vote the ``n_real`` live families of a dense batch on ``device``
    under ``policy``: the stacked ``(2, n_real, L)`` uint8 planes on
    ``device`` (the size-0 slots that pad the batch to a power of two are
    neither uploaded nor voted; they vote all-N and no QC), and with
    ``qc`` the rider's ``(2, L)`` int32 sums."""
    n = batch.n_real
    obs_metrics.note_transfer("h2d", batch.bases[:n].nbytes + batch.quals[:n].nbytes, device)
    bases = torch.from_numpy(batch.bases[:n]).to(device)
    quals = torch.from_numpy(batch.quals[:n]).to(device)
    out = consensus_vote.consensus_batch(bases, quals, torch.from_numpy(batch.fam_sizes[:n]),
                                         config, qc=qc, policy=policy)
    planes = torch.stack(out[:2])
    return (planes, out[2]) if qc else planes


def consensus_batch_host(bases, quals, fam_sizes, config: ConsensusConfig,
                         device: torch.device):
    """Vote a padded ``(B, F, L)`` batch (PAD in unused member slots and
    positions, ``fam_sizes`` ``(B,)``, 0 for a dummy slot) on ``device``:
    host ``(B, L)`` uint8 ``(bases, quals)``; dummy slots come back all
    ``(N, 0)``.  On the card, one launch of B1's dense form."""
    b = np.ascontiguousarray(bases, dtype=np.uint8)
    q = np.ascontiguousarray(quals, dtype=np.uint8)
    sizes = np.asarray(fam_sizes, dtype=np.int32)
    obs_metrics.note_transfer("h2d", b.nbytes + q.nbytes + sizes.nbytes, device)
    out_b, out_q = consensus_vote.consensus_batch(
        torch.from_numpy(b).to(device), torch.from_numpy(q).to(device),
        torch.from_numpy(sizes), config)[:2]
    obs_metrics.note_transfer("d2h", out_b.nbytes + out_q.nbytes, device)
    return out_b.cpu().numpy(), out_q.cpu().numpy()


def qc_member_reduction(bases: torch.Tensor, quals: torch.Tensor, fam_sizes: torch.Tensor,
                        *, qual_threshold: int):
    """The QC reduction over family-major ``(F, B, L)`` member planes and
    ``(B,)`` sizes, on their device: batch-summed ``(L,)`` int32 ``(votes,
    disagree)``.  A member slot past its family's size votes nothing (PAD
    is no lane), a member below ``qual_threshold`` votes N; ``disagree``
    is the votes off each position's modal lane."""
    fam_cap = bases.shape[0]
    member = (torch.arange(fam_cap, device=bases.device)[:, None]
              < fam_sizes.to(bases.device)[None, :])[:, :, None]
    eff = torch.where(quals >= qual_threshold, bases, N)
    eff = torch.where(member, eff, PAD)
    lanes = torch.arange(NUM_BASES, dtype=torch.uint8, device=bases.device)
    counts = (eff[..., None] == lanes).sum(0, dtype=torch.int32)  # (B, L, 5)
    votes = counts.sum(-1, dtype=torch.int32)
    disagree = votes - counts.amax(-1)
    return votes.sum(0, dtype=torch.int32), disagree.sum(0, dtype=torch.int32)


def consensus_families(families, config: ConsensusConfig, device: torch.device,
                       max_batch: int = 1024, prefetch_depth: int = DEFAULT_DEPTH,
                       on_batch=None, policy=DEFAULT_POLICY, mesh=None):
    """Stream ragged families through the dense vote, double-buffered.

    ``families`` yields ``(key, member_seqs, member_quals)`` (ragged lists
    of 1-D uint8 arrays); yields ``(key, consensus_base, consensus_qual)``
    with outputs sliced to each family's true consensus length, in bucket
    order.  Host grouping and padding run on a producer thread
    ``prefetch_depth`` batches ahead (``0``: serial, no thread), and one
    batch is in flight on the device while the previous one downloads.
    ``on_batch(batch)`` is called with each ``FamilyBatch`` at dispatch.
    ``policy``: the vote policy of every batch.

    ``mesh``: a ``parallel.mesh.Mesh``; each batch's live families are
    then padded to a mesh multiple (``pad_batch_to_mesh``) and voted family
    sharded (``sharded_vote_async``: B1's dense form per shard), with no
    QC rider, as the JAX package's dense mesh branch."""
    name = get_policy(policy).name
    if mesh is not None and name != DEFAULT_POLICY:
        raise ValueError(f"vote policy {name!r} is single-device only")
    qc_sink = obs_qc.plane_sink() if mesh is None else None
    qc_total = torch.zeros((2, 0), dtype=torch.int64, device=device)

    def vote(batch):
        if mesh is None:
            return consensus_batch(batch, config, device, qc=qc_sink is not None, policy=policy)
        n = batch.n_real
        bases, quals, sizes, _lengths, _n = mesh_mod.pad_batch_to_mesh(
            batch.bases[:n], batch.quals[:n], batch.fam_sizes[:n], mesh)
        return torch.stack(mesh_mod.sharded_vote_async(bases, quals, sizes, mesh, config))

    def dispatch(batch):
        nonlocal qc_total
        if on_batch is not None:
            on_batch(batch)
        with obs_trace.span("device.dispatch", histogram="device_dispatch_s",
                            n_real=batch.n_real):
            # under CCT_SANITIZE the batch's upload with its launch is a
            # sanctioned transfer of the stage (utils.sanitize); the QC
            # sums and the download's start (pinned, asynchronous) run
            # guarded
            with sanitize.allow_transfer("dense batch upload and vote"):
                planes = vote(batch)
            if qc_sink is not None:
                planes, sums = planes
                qc_total = _add_qc(qc_total, sums)
            obs_metrics.note_transfer("d2h", planes.nbytes, device)
            return start_fetch(planes)

    def fetch(batch, handle):
        with sanitize.allow_transfer("dense batch download"):
            out = handle.result()[0]
        for i, key in enumerate(batch.keys):
            length = int(batch.lengths[i])
            yield key, out[0, i, :length], out[1, i, :length]

    stream = prefetch(bucket_families(families, max_batch=max_batch), depth=prefetch_depth)
    try:
        yield from pipelined(stream, dispatch, fetch)
    finally:
        # closing the stream stops and joins the producer thread, so the
        # caller's cleanup (closing writers the producer writes to) cannot
        # race it
        stream.close()
        if qc_sink is not None and qc_total.shape[1]:
            qc_sink.add_plane_handle(qc_total)
