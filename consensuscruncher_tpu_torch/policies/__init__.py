"""Pluggable consensus vote policies (port of ``consensuscruncher_tpu/policies``).

Importing this package registers the three built-ins (majority,
delegation, distilled).  See ``policies/base.py`` for the plane protocol.
"""

from consensuscruncher_tpu_torch.policies.base import (
    DEFAULT_POLICY,
    VotePolicy,
    available_policies,
    family_planes,
    get_policy,
    modal_with_tiebreak,
    register_policy,
)
from consensuscruncher_tpu_torch.policies.delegation import (
    DELEGATE_THRESHOLD,
    DelegationPolicy,
    delegated_weights,
)
from consensuscruncher_tpu_torch.policies.distilled import (
    CHECKPOINT_ENV,
    DistilledHead,
    DistilledPolicy,
    checkpoint_path,
    head_from_params,
    load_checkpoint,
)
from consensuscruncher_tpu_torch.policies.majority import MajorityPolicy, majority_family_vote

__all__ = [
    "DEFAULT_POLICY",
    "DELEGATE_THRESHOLD",
    "CHECKPOINT_ENV",
    "VotePolicy",
    "MajorityPolicy",
    "DelegationPolicy",
    "DistilledPolicy",
    "DistilledHead",
    "available_policies",
    "checkpoint_path",
    "delegated_weights",
    "family_planes",
    "get_policy",
    "head_from_params",
    "load_checkpoint",
    "majority_family_vote",
    "modal_with_tiebreak",
    "register_policy",
]
