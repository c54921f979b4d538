"""Pluggable consensus vote policies: the plane protocol and the registry.

Port of ``consensuscruncher_tpu/policies/base.py``.  A policy is the rule
that reduces a family's member planes to one consensus ``(position,)``
base/quality pair:

- ``decide(counts, quals, lengths) -> (bases, phreds, fail_mask)`` is the
  plane protocol: ``counts`` the effective one-hot vote plane ``(..., F,
  L, NUM_BASES)`` (bool; quality-demoted members vote the N lane, padded
  member slots vote no lane), ``quals`` the member-masked Phred plane
  ``(..., F, L)``, ``lengths`` the family's true member count ``(...)``.
  ``fail_mask`` marks the positions the policy abstains on (emitted as
  N/0).  Leading dimensions are families: the reference's ``decide`` takes
  one family, the port's any batch of them.
- :meth:`VotePolicy.family_vote_fn` is the batched counterpart of the
  reference's per-family callable (which the JAX package ``vmap``\\ s):
  ``(NF, F, L)`` planes and ``(NF,)`` sizes in, ``(NF, L)`` planes out.

Both reduce the member axis lane by lane (:class:`Lanes`): the vote never
builds a 5-wide one-hot of a whole batch, which at the main path's batch
(21,388 families, 16 slots, 104 positions) would hold 178 MB of bools.
Every operation is a torch op on the planes' device.

The majority default never comes here on the port's wires: they launch
the hand kernel B1 (``ops.consensus_vote``) for it, and route only the
other policies through :meth:`VotePolicy.family_vote_fn`.  The policy is
passed explicitly, from ``stages.sscs_maker.run_sscs`` down to the vote
calls; the reference's module-global ``set_vote_policy`` hook has no
counterpart.
"""

from __future__ import annotations

import torch

from consensuscruncher_tpu_torch.utils.phred import N, NUM_BASES, PAD

#: The policy every wire runs when nothing else is asked for: the
#: reference rational-cutoff majority vote (golden-pinned).
DEFAULT_POLICY = "majority"


class Lanes:
    """The effective vote plane, one lane at a time: ``lane(k)`` is the
    ``(..., F, L)`` bool plane of the members voting lane ``k``, and
    ``member()`` the members voting any lane."""

    def __init__(self, lane, member):
        self.lane, self.member = lane, member

    @classmethod
    def from_onehot(cls, onehot: torch.Tensor) -> "Lanes":
        """From a one-hot ``(..., F, L, NUM_BASES)`` bool plane."""
        return cls(lambda k: onehot[..., k], lambda: onehot.any(-1))

    @classmethod
    def from_codes(cls, eff: torch.Tensor) -> "Lanes":
        """From ``(..., F, L)`` uint8 effective codes: lane ``k`` is ``eff ==
        k``; PAD (and any code past N) votes no lane."""
        return cls(lambda k: eff == k, lambda: eff < NUM_BASES)

    def masked(self, active: torch.Tensor) -> "Lanes":
        """The votes of the ``active`` ``(..., F, L)`` members only."""
        return Lanes(lambda k: self.lane(k) & active, lambda: self.member() & active)

    def counts(self) -> list[torch.Tensor]:
        """The ``(..., L)`` int32 vote count of every lane."""
        return [self.lane(k).sum(-2, dtype=torch.int32) for k in range(NUM_BASES)]


def family_planes(bases, quals, fam_size, *, qual_threshold):
    """Member planes ``(..., F, L)`` + sizes ``(...)`` -> the plane-level
    ``decide`` operands: the one-hot ``(..., F, L, NUM_BASES)`` bool vote
    plane and the member-masked ``(..., F, L)`` int32 quals.

    The effective vote of the reference kernel: members below the quality
    threshold vote N, padded member slots vote nothing (PAD matches no
    lane)."""
    eff, mq = _effective(bases, quals, fam_size, qual_threshold)
    lanes = torch.arange(NUM_BASES, dtype=torch.uint8, device=bases.device)
    return eff[..., None] == lanes, mq.to(torch.int32)


def _effective(bases, quals, fam_size, qual_threshold):
    """``(eff, mq)``: the effective uint8 codes (N under the threshold, PAD
    outside the family) and the member-masked uint8 quals."""
    size = torch.as_tensor(fam_size).to(device=bases.device, dtype=torch.int64)
    # (..., F, 1): slot r of a family is a member iff r < size
    member = (torch.arange(bases.shape[-2], device=bases.device) < size[..., None])[..., None]
    eff = torch.where(quals >= qual_threshold, bases, N)
    eff = torch.where(member, eff, PAD).to(torch.uint8)
    mq = torch.where(member, quals, 0).to(quals.dtype)
    return eff, mq


def modal_with_tiebreak(votes):
    """Lexicographic (count desc, first-seen asc) modal pick over a
    ``(..., F, L, NUM_BASES)`` bool vote plane (or :class:`Lanes`) ->
    ``(modal int64, max_count int32)``, each ``(..., L)``.

    The reference's tie-break (CPython ``Counter.most_common`` insertion
    order): among the lanes at the top count, the one first voted by the
    earliest member wins.  Integer-exact, with no combined score."""
    lanes = votes if isinstance(votes, Lanes) else Lanes.from_onehot(votes)
    counts, firsts = [], []
    for k in range(NUM_BASES):
        plane = lanes.lane(k)
        fam_cap = plane.shape[-2]
        rank = torch.arange(fam_cap, dtype=torch.int32, device=plane.device)[:, None]
        counts.append(plane.sum(-2, dtype=torch.int32))
        firsts.append(torch.where(plane, rank, fam_cap).amin(-2))
    max_count = counts[0]
    for k in range(1, NUM_BASES):
        max_count = torch.maximum(max_count, counts[k])
    # argmin over the candidates' first-seen ranks; the strict compare keeps
    # the lowest lane among equal candidates (every lane of an empty
    # position ties at fam_cap), as jnp.argmin does
    best = torch.where(counts[0] == max_count, firsts[0], fam_cap + 1)
    modal = torch.zeros_like(best, dtype=torch.int64)
    for k in range(1, NUM_BASES):
        cand = torch.where(counts[k] == max_count, firsts[k], fam_cap + 1)
        better = cand < best
        best = torch.where(better, cand, best)
        modal = torch.where(better, k, modal)
    return modal, max_count


def lane_qsums(lanes: Lanes, quals: torch.Tensor) -> list[torch.Tensor]:
    """Per lane, the ``(..., L)`` int32 sum of its voters' quals."""
    return [torch.where(lanes.lane(k), quals, 0).sum(-2, dtype=torch.int32)
            for k in range(NUM_BASES)]


def pick_lane(planes: list[torch.Tensor], modal: torch.Tensor) -> torch.Tensor:
    """``planes[modal]`` elementwise, for a ``(..., L)`` lane index."""
    out = planes[0]
    for k in range(1, NUM_BASES):
        out = torch.where(modal == k, planes[k], out)
    return out


def check_cutoff(fam_cap: int, num: int, den: int) -> None:
    """The static int32 guard of the rational cutoff compare."""
    if fam_cap * max(den, num) >= 2**31:
        raise ValueError(
            f"family bucket {fam_cap} with cutoff {num}/{den} would "
            "overflow the int32 cutoff compare")


class VotePolicy:
    """One consensus vote rule over the family count/qual planes.

    Subclasses set :attr:`name` and implement :meth:`decide_lanes`.  A
    policy is deterministic: a name always produces the same bytes."""

    #: registry key; also the ``--policy`` CLI value
    name: str = "?"

    def prepare(self) -> None:
        """Load what the policy needs before any output exists (raises on
        a bad checkpoint); the rule-only policies need nothing."""

    def decide(self, counts, quals, lengths, *, num, den, qual_threshold, qual_cap):
        """Plane-level vote: ``(..., F, L, 5)`` one-hot counts + ``(..., F,
        L)`` masked quals + family sizes ``(...)`` -> ``(bases, phreds,
        fail_mask)``, each ``(..., L)`` (fail positions are masked to N/0
        by :meth:`family_vote_fn`)."""
        return self.decide_lanes(Lanes.from_onehot(counts), quals, torch.as_tensor(lengths),
                                 num=num, den=den, qual_threshold=qual_threshold,
                                 qual_cap=qual_cap)

    def decide_lanes(self, lanes: Lanes, quals, lengths, *, num, den, qual_threshold,
                     qual_cap):
        raise NotImplementedError

    def family_vote_fn(self, *, num, den, qual_threshold, qual_cap, with_qc=False):
        """Batched family vote ``(bases, quals, sizes) -> (out_base,
        out_qual[, votes, disagree])``: ``(NF, F, L)`` uint8 member planes
        and ``(NF,)`` sizes on one device -> ``(NF, L)`` uint8 planes on it.

        The QC rider (``with_qc``: per family and position, the total votes
        and the votes disagreeing with the modal lane, as ``(NF, L)`` int32)
        is a property of the member planes, not of the policy's choice: it
        is the same for every policy."""

        def fn(bases, quals, sizes):
            sizes = torch.as_tensor(sizes).to(device=bases.device, dtype=torch.int32)
            eff, mq = _effective(bases, quals, sizes, qual_threshold)
            lanes = Lanes.from_codes(eff)
            out_b, out_q, fail = self.decide_lanes(
                lanes, mq, sizes, num=num, den=den, qual_threshold=qual_threshold,
                qual_cap=qual_cap)
            out_b = torch.where(fail, N, out_b).to(torch.uint8)
            out_q = torch.where(fail, 0, out_q).to(torch.uint8)
            if not with_qc:
                return out_b, out_q
            counts = lanes.counts()
            votes, top = counts[0], counts[0]
            for k in range(1, NUM_BASES):
                votes = votes + counts[k]
                top = torch.maximum(top, counts[k])
            return out_b, out_q, votes, votes - top

        return fn


# ------------------------------------------------------------- registry

_REGISTRY: dict[str, VotePolicy] = {}


def register_policy(policy: VotePolicy) -> VotePolicy:
    """Register a policy instance under its name (the three built-ins
    register when their modules load)."""
    if not policy.name or policy.name == "?":
        raise ValueError("vote policy must set a name")
    _REGISTRY[policy.name] = policy
    return policy


def _ensure_builtins() -> None:
    """Load the built-in policy modules for their registration side
    effects, so resolution by name does not depend on import order."""
    from consensuscruncher_tpu_torch.policies import (  # noqa: F401
        delegation,
        distilled,
        majority,
    )


def available_policies() -> tuple[str, ...]:
    """Registered policy names, sorted (the ``--policy`` vocabulary)."""
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def get_policy(name) -> VotePolicy:
    """Resolve a policy by name (or pass a :class:`VotePolicy` through);
    an unknown name raises ``ValueError``."""
    if isinstance(name, VotePolicy):
        return name
    _ensure_builtins()
    policy = _REGISTRY.get(str(name))
    if policy is None:
        raise ValueError(
            f"unknown vote policy {name!r}; expected one of "
            f"{available_policies()}")
    return policy
