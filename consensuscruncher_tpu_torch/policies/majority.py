"""Majority policy: the reference rational-cutoff vote.

Port of ``consensuscruncher_tpu/policies/majority.py``.  The default
everywhere, and the only policy pinned to the committed goldens.  On the
port's wires its vote is the hand kernel B1 (``ops.consensus_vote``: the
stream form, the dense form, and B2 for the fused duplex vote), whose
plain version is ``ops.consensus_vote.vote_members_plain``; the wires
never route majority through :meth:`MajorityPolicy.family_vote_fn`.
:func:`majority_family_vote` is the reference's per-family entry: one
padded family through B1's dense form.  :meth:`decide` is the same rule
over the plane protocol, for callers that work at that level.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from consensuscruncher_tpu_torch.ops import consensus_vote
from consensuscruncher_tpu_torch.policies.base import (
    Lanes,
    VotePolicy,
    check_cutoff,
    lane_qsums,
    modal_with_tiebreak,
    pick_lane,
    register_policy,
)
from consensuscruncher_tpu_torch.utils.phred import N, NUM_BASES, PAD  # noqa: F401

__all__ = ["MajorityPolicy", "majority_family_vote"]


@dataclass(frozen=True)
class _RationalConfig(consensus_vote.ConsensusConfig):
    """A config whose cutoff is the exact rational ``num / den``."""

    num: int = 7
    den: int = 10

    @property
    def cutoff_rational(self) -> tuple[int, int]:
        return self.num, self.den


def majority_family_vote(bases, quals, fam_size, *, num, den, qual_threshold, qual_cap,
                         with_qc=False):
    """Consensus of one padded family: ``(F, L)`` uint8 planes and its size
    -> the ``(L,)`` uint8 bases and quals, on the planes' device.  Members
    ``>= fam_size`` never vote.  On CUDA planes it is one launch of B1's
    dense form (``ops.consensus_vote.consensus_batch`` with one family), on
    CPU planes its plain version.

    ``with_qc``: also return the QC rider, the ``(L,)`` int32 votes and
    votes disagreeing with the modal lane at every position, as
    ``(bases, quals, votes, disagree)``.  The consensus is the same either
    way.  A size above ``F`` raises (the reference lets every slot vote
    then and divides by the size)."""
    fam_cap = bases.shape[0]
    if fam_cap * max(den, num) >= 2**31:
        raise ValueError(
            f"family bucket {fam_cap} with cutoff {num}/{den} would overflow "
            "the int32 cutoff compare — split the family or coarsen the cutoff")
    config = _RationalConfig(qual_threshold=int(qual_threshold), qual_cap=int(qual_cap),
                             num=int(num), den=int(den))
    size = torch.as_tensor(fam_size).reshape(1)
    out = consensus_vote.consensus_batch(bases[None], quals[None], size, config, qc=with_qc)
    if with_qc:
        return out[0][0], out[1][0], out[2][0], out[2][1]
    return out[0][0], out[1][0]


class MajorityPolicy(VotePolicy):
    """Exact rational-cutoff majority: the modal lane (first-seen
    tie-break) passes iff ``count * den >= num * fam_size``, in integers."""

    name = "majority"

    def decide_lanes(self, lanes: Lanes, quals, lengths, *, num, den, qual_threshold,
                     qual_cap):
        check_cutoff(lanes.lane(0).shape[-2], num, den)
        lengths = torch.as_tensor(lengths).to(torch.int32)[..., None]
        modal, max_count = modal_with_tiebreak(lanes)
        passed = (modal != N) & (max_count * den >= num * lengths) & (lengths > 0)
        qsum = pick_lane(lane_qsums(lanes, quals), modal)
        return (modal.to(torch.uint8), qsum.clamp(max=qual_cap).to(torch.uint8), ~passed)


register_policy(MajorityPolicy())
