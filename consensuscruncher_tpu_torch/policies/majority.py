"""Majority policy: the reference rational-cutoff vote.

Port of ``consensuscruncher_tpu/policies/majority.py``.  The default
everywhere, and the only policy pinned to the committed goldens.  On the
port's wires its vote is the hand kernel B1 (``ops.consensus_vote``: the
stream form, the dense form, and B2 for the fused duplex vote), whose
plain version is ``ops.consensus_vote.vote_members_plain``, re-exported
here as :data:`majority_family_vote`; the wires never route majority
through :meth:`MajorityPolicy.family_vote_fn`.  :meth:`decide` is the
same rule over the plane protocol, for callers that work at that level.
"""

from __future__ import annotations

import torch

from consensuscruncher_tpu_torch.ops.consensus_vote import (
    vote_members_plain as majority_family_vote,
)
from consensuscruncher_tpu_torch.policies.base import (
    Lanes,
    VotePolicy,
    check_cutoff,
    lane_qsums,
    modal_with_tiebreak,
    pick_lane,
    register_policy,
)
from consensuscruncher_tpu_torch.utils.phred import N

__all__ = ["MajorityPolicy", "majority_family_vote"]


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
