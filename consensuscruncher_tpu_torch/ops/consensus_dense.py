"""The dense wire (``--wire dense``): padded ``(B, F, L)`` family batches.

Port of the dense half of ``consensuscruncher_tpu/ops/consensus_tpu.py``
(``consensus_batch``, ``consensus_families``).  Ragged families bucket into
``parallel.batching.FamilyBatch``es on a producer thread; each batch's live
families upload as their ``(n, F, L)`` slots and vote in one launch of B1's
dense form (``ops.consensus_vote.consensus_batch``: family ``i`` at rows
``i * F ..`` of the member stream), with one batch in flight while the
previous one downloads.  The JAX CLI's dense wire runs the XLA program
``majority_family_vote`` under ``vmap`` here; B1's dense form computes the
same function.  Under a vote policy other than majority each batch votes
by the policy (``consensus_vote.consensus_batch(..., policy=)``).

While an ``obs.qc`` plane sink is armed, every batch carries the dense
rider (see ``consensus_vote.consensus_batch``: every position of the
padded width, no length mask), summed on the device into one int64 total
that goes to the sink as one handle when the batches end.
"""

from __future__ import annotations

import torch

from consensuscruncher_tpu_torch.obs import qc as obs_qc
from consensuscruncher_tpu_torch.ops import consensus_vote
from consensuscruncher_tpu_torch.ops.consensus_segment import _add_qc
from consensuscruncher_tpu_torch.ops.consensus_vote import ConsensusConfig
from consensuscruncher_tpu_torch.parallel.batching import FamilyBatch, bucket_families
from consensuscruncher_tpu_torch.parallel.prefetch import (
    DEFAULT_DEPTH,
    pipelined,
    prefetch,
    start_fetch,
)
from consensuscruncher_tpu_torch.policies import DEFAULT_POLICY


def consensus_batch(batch: FamilyBatch, config: ConsensusConfig, device: torch.device,
                    qc: bool = False, policy=DEFAULT_POLICY):
    """Vote the ``n_real`` live families of a dense batch on ``device``
    under ``policy``: the stacked ``(2, n_real, L)`` uint8 planes on
    ``device`` (the size-0 slots that pad the batch to a power of two are
    neither uploaded nor voted; they vote all-N and no QC), and with
    ``qc`` the rider's ``(2, L)`` int32 sums."""
    n = batch.n_real
    bases = torch.from_numpy(batch.bases[:n]).to(device)
    quals = torch.from_numpy(batch.quals[:n]).to(device)
    out = consensus_vote.consensus_batch(bases, quals, torch.from_numpy(batch.fam_sizes[:n]),
                                         config, qc=qc, policy=policy)
    planes = torch.stack(out[:2])
    return (planes, out[2]) if qc else planes


def consensus_families(families, config: ConsensusConfig, device: torch.device,
                       max_batch: int = 1024, prefetch_depth: int = DEFAULT_DEPTH,
                       on_batch=None, policy=DEFAULT_POLICY):
    """Stream ragged families through the dense vote, double-buffered.

    ``families`` yields ``(key, member_seqs, member_quals)`` (ragged lists
    of 1-D uint8 arrays); yields ``(key, consensus_base, consensus_qual)``
    with outputs sliced to each family's true consensus length, in bucket
    order.  Host grouping and padding run on a producer thread
    ``prefetch_depth`` batches ahead (``0``: serial, no thread), and one
    batch is in flight on the device while the previous one downloads.
    ``on_batch(batch)`` is called with each ``FamilyBatch`` at dispatch.
    ``policy``: the vote policy of every batch."""
    qc_sink = obs_qc.plane_sink()
    qc_total = torch.zeros((2, 0), dtype=torch.int64, device=device)

    def dispatch(batch):
        nonlocal qc_total
        if on_batch is not None:
            on_batch(batch)
        planes = consensus_batch(batch, config, device, qc=qc_sink is not None,
                                 policy=policy)
        if qc_sink is not None:
            planes, sums = planes
            qc_total = _add_qc(qc_total, sums)
        return start_fetch(planes)

    def fetch(batch, handle):
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
