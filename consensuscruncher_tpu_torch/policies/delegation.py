"""Delegation policy: low-quality reads delegate their vote weight to the
high-quality reads of their family.

Port of ``consensuscruncher_tpu/policies/delegation.py``.  Every member
holds weight 1; members with Phred >= ``DELEGATE_THRESHOLD`` ("high") keep
it and vote their own base, members below it split theirs equally over
the high members; at a position with no high member everyone keeps their
own vote (exact majority).  The total weight per position is always the
family size (:func:`delegated_weights`).  With equal splitting the
weighted cutoff reduces to integers, ``count_high[b] * den >= num *
n_high``: majority among the high members with the rational cutoff
applied to their number, which is what :meth:`DelegationPolicy.decide`
computes (no float compare).

Delegation equals majority on any input whose quals are all at least the
threshold: every member is then high.
"""

from __future__ import annotations

import torch

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

#: Phred floor for a member to keep its own vote: between the simulator's
#: degraded band (<= 15) and its healthy band (>= 25).  Part of the
#: policy's identity, not a tunable.
DELEGATE_THRESHOLD = 20


def delegated_weights(quals, member, fam_size, threshold=DELEGATE_THRESHOLD):
    """Per-member, per-position float vote weights ``(F, L)``, for the
    conservation invariant ``weights.sum(0) == member.sum(0)`` (tests
    only; the vote itself stays in integers).  ``fam_size`` is unused, as
    in the reference's signature."""
    quals, member = torch.as_tensor(quals), torch.as_tensor(member)
    high = member & (quals >= threshold)
    n_high = high.sum(0)
    n_low = member.sum(0) - n_high
    w_high = 1.0 + n_low / torch.clamp(n_high, min=1)
    weights = torch.where(high, w_high[None, :], 0.0)
    # all-low fallback: no delegate exists, everyone keeps their weight
    return torch.where((n_high == 0)[None, :], member * 1.0, weights)


class DelegationPolicy(VotePolicy):
    """Quality-threshold delegation with weight conservation."""

    name = "delegation"
    delegate_threshold = DELEGATE_THRESHOLD

    def decide_lanes(self, lanes: Lanes, quals, lengths, *, num, den, qual_threshold,
                     qual_cap):
        check_cutoff(lanes.lane(0).shape[-2], num, den)
        lengths = torch.as_tensor(lengths).to(torch.int32)[..., None]
        member = lanes.member()                      # padded slots vote no lane
        high = member & (quals >= self.delegate_threshold)
        n_high = high.sum(-2, dtype=torch.int32)     # (..., L)
        use_all = n_high == 0
        votes = lanes.masked(torch.where(use_all[..., None, :], member, high))
        modal, max_count = modal_with_tiebreak(votes)
        # exact integer cutoff over the active voters (the weighted compare
        # over the conserved family total; module docstring)
        n_active = torch.where(use_all, lengths, n_high)
        passed = (modal != N) & (max_count * den >= num * n_active) & (lengths > 0)
        qsum = pick_lane(lane_qsums(votes, quals), modal)
        return (modal.to(torch.uint8), qsum.clamp(max=qual_cap).to(torch.uint8), ~passed)


register_policy(DelegationPolicy())
