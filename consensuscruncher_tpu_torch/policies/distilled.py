"""Distilled policy: a small frozen error-correction head over the
per-position count/qual features.

Port of ``consensuscruncher_tpu/policies/distilled.py``.  A per-position
MLP (``features -> tanh hidden -> 5 base logits``), trained offline by the
JAX package's ``tools/distill_train.py`` (or by this package's
``policies.distill_train``) and shipped as a versioned checkpoint
(``checkpoints/distilled_v1.json``, a byte-for-byte copy of the JAX
package's).  Features per position (11): the 5 lane count fractions,
the 5 lane quality-mass fractions (each lane's Phred sum over ``fam_size *
qual_cap``) and the clipped family size.  The head votes the argmax lane
and abstains (N/0) where the softmax confidence is below
:data:`CONFIDENCE_FLOOR`, the argmax is the N lane, or the family is empty.

Checkpoint resolution: ``CCT_DISTILLED_CHECKPOINT`` (environment) wins,
else the committed file.

Float32, as the reference computes it, in an arithmetic that gives the
same bits on the CPU and on the card: the two small products are sums of
exact products accumulated in float64 in a fixed order (no matmul, so no
TF32 and no library summation order); ``tanh`` is the rational
approximation XLA's CPU backend uses (the same bits as the JAX package's
``jnp.tanh`` on the CPU), with its fused multiply-adds taken in float64;
``exp`` is rounded from float64.  Only ``+ - * /``, compares and selects
on the planes' device.  :func:`forward` is differentiable for the trainer
(``policies.distill_train``): ``tanh`` takes the JAX package's derivative
rule, and the chain rule's products run as float64 matmuls.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from consensuscruncher_tpu_torch.policies.base import (
    Lanes,
    VotePolicy,
    lane_qsums,
    pick_lane,
    register_policy,
)
from consensuscruncher_tpu_torch.utils.phred import N, NUM_BASES

#: The committed checkpoint.
CHECKPOINT_NAME = "distilled_v1.json"
CHECKPOINT_ENV = "CCT_DISTILLED_CHECKPOINT"

#: Softmax confidence below which the head abstains (votes N).  Part of
#: the policy's identity, like the delegation threshold.
CONFIDENCE_FLOOR = 0.5

#: Family-size feature clip (sizes past this carry no extra signal).
FAM_CLIP = 32.0

N_FEATURES = 2 * NUM_BASES + 1

# XLA's float32 tanh: clamp, then x * P(x^2) / Q(x^2), each Horner step a
# fused multiply-add; tanh(x) = x below 4e-4
_TANH_CLAMP = 7.99881172180175781
_TANH_SMALL = 0.0004
_TANH_P = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
           5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
           4.89352455891786e-03)
_TANH_Q = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
           4.89352518554385e-03)


def checkpoint_path() -> str:
    env = os.environ.get(CHECKPOINT_ENV)
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints",
                        CHECKPOINT_NAME)


def load_checkpoint(path: str | None = None) -> dict:
    """Parse and validate a checkpoint file into float32 weight arrays
    (the dict the JAX package's ``load_checkpoint`` returns).  Raises
    ValueError on a wrong version or wrong shapes."""
    path = path or checkpoint_path()
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("version") != 1 or doc.get("policy") != "distilled":
        raise ValueError(f"not a distilled-policy checkpoint: {path}")
    params = {}
    for key in ("w1", "b1", "w2", "b2"):
        params[key] = np.asarray(doc[key], dtype=np.float32)
    hidden = params["b1"].shape[0]
    want = {"w1": (N_FEATURES, hidden), "b1": (hidden,),
            "w2": (hidden, NUM_BASES), "b2": (NUM_BASES,)}
    for key, shape in want.items():
        if params[key].shape != shape:
            raise ValueError(
                f"checkpoint {path}: {key} has shape {params[key].shape}, want {shape}")
    params["meta"] = doc.get("meta") or {}
    return params


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``round32(a * b + c)`` from float32 operands, the product exact in
    float64: a fused multiply-add."""
    return (a.double() * b + c).float()


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    """float32 ``tanh`` as XLA's CPU backend computes it."""
    xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = (xc * xc).double()
    p = torch.full_like(xc, _TANH_P[0])
    for c in _TANH_P[1:]:
        p = x2.mul(p).add_(float(np.float32(c))).float()
    p = xc * p
    q = torch.full_like(xc, _TANH_Q[0])
    for c in _TANH_Q[1:]:
        q = x2.mul(q).add_(float(np.float32(c))).float()
    return torch.where(x.abs() < _TANH_SMALL, x, p / q)


class _Affine(torch.autograd.Function):
    """float32 ``x @ w + b`` over the last axis: the exact products summed
    in float64 in input order, rounded once, then the bias added.  Its
    derivative: the two products of the chain rule in float64, rounded
    once, and the bias's the sum of the incoming gradient."""

    @staticmethod
    def forward(ctx, x, w, b):
        xd, wd = x.double(), w.double()
        acc = xd[..., 0:1] * wd[0]
        for k in range(1, w.shape[0]):
            acc.addcmul_(xd[..., k:k + 1], wd[k])
        ctx.save_for_backward(x, w)
        return acc.float() + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gd = g.double()
        gx = (gd @ w.double().T).float() if ctx.needs_input_grad[0] else None
        gw = (x.double().reshape(-1, x.shape[-1]).T @ gd.reshape(-1, g.shape[-1])).float()
        return gx, gw, g.reshape(-1, g.shape[-1]).sum(0)


class _Tanh(torch.autograd.Function):
    """:func:`xla_tanh` with the derivative the JAX package's autodiff
    applies to ``jnp.tanh`` at default accuracy, ``(g + g * y) * (1 - y)``
    with ``y`` the forward's output, in the form XLA's CPU backend runs
    its transpose: ``t = g * (1 - y)``, then ``t + t * y`` as one fused
    multiply-add.  The rational approximation itself is never
    differentiated."""

    @staticmethod
    def forward(ctx, x):
        y = xla_tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        t = g * (1 - y)
        return _fma(t, y.double(), t.double())


def forward(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """The head itself, ``tanh(x @ w1 + b1) @ w2 + b2``: ``(..., 11)``
    float32 features -> ``(..., 5)`` logits, on the features' device.
    ``params`` holds ``w1`` ``(11, hidden)``, ``b1``, ``w2`` ``(hidden, 5)``
    and ``b2``, as tensors or arrays; it is differentiable in tensors that
    require grad (the training tool, ``policies.distill_train``)."""
    w1, b1, w2, b2 = (torch.as_tensor(params[k], dtype=torch.float32, device=feats.device)
                      for k in ("w1", "b1", "w2", "b2"))
    return _Affine.apply(_Tanh.apply(_Affine.apply(feats, w1, b1)), w2, b2)


class DistilledHead(nn.Module):
    """The head of :func:`forward` with its weights frozen as float32
    buffers in the reference's layout (``w1`` ``(11, hidden)``, ``w2``
    ``(hidden, 5)``)."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        for name, value in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
            self.register_buffer(name, torch.as_tensor(np.asarray(value, np.float32)))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return forward({"w1": self.w1, "b1": self.b1, "w2": self.w2, "b2": self.b2}, feats)


def head_from_params(params: dict) -> DistilledHead:
    """The weights carried across: the dict of the JAX package's
    ``load_checkpoint`` (or this module's) -> a :class:`DistilledHead`."""
    return DistilledHead(params["w1"], params["b1"], params["w2"], params["b2"])


@lru_cache(maxsize=4)
def _checkpoint_head(path: str, device: torch.device) -> DistilledHead:
    return head_from_params(load_checkpoint(path)).to(device)


def checkpoint_forward(feats, path: str | None = None) -> torch.Tensor:
    """The head of the checkpoint at ``path`` (default: the resolved
    checkpoint) on ``feats``, on their device; one head is kept per path
    and device."""
    if not isinstance(feats, torch.Tensor):
        feats = torch.from_numpy(np.array(feats, np.float32))
    with torch.no_grad():
        return _checkpoint_head(path or checkpoint_path(), feats.device)(feats)


def features(counts, qsums, lengths, *, qual_cap):
    """Per-position features ``(..., L, 11)`` from the ``(..., L, 5)`` lane
    counts and Phred sums and the family sizes ``(...)`` (or ``(..., L)``)."""
    lengths = torch.as_tensor(lengths, dtype=torch.float32).to(counts.device)
    if lengths.dim() < counts.dim() - 1:
        lengths = lengths[..., None]
    fam = torch.clamp(lengths, min=1.0).expand(counts.shape[:-1])[..., None]
    f_counts = counts.float() / fam
    f_quals = qsums.float() / (fam * float(qual_cap))
    f_fam = torch.clamp(fam, max=FAM_CLIP) / FAM_CLIP
    return torch.cat([f_counts, f_quals, f_fam], -1)


def confidence(logits: torch.Tensor) -> torch.Tensor:
    """The softmax maximum of ``(..., 5)`` logits: ``1 / sum(exp(l - max))``
    (the top lane's ``exp`` is exactly 1), the sum in lane order."""
    e = (logits - logits.amax(-1, keepdim=True)).double().exp().float()
    s = e[..., 0]
    for k in range(1, NUM_BASES):
        s = s + e[..., k]
    return 1.0 / s


def first_max(logits: torch.Tensor) -> torch.Tensor:
    """The argmax lane of ``(..., 5)`` logits, the lowest lane on a tie."""
    best, lane = logits[..., 0], torch.zeros(logits.shape[:-1], dtype=torch.int64,
                                             device=logits.device)
    for k in range(1, NUM_BASES):
        better = logits[..., k] > best
        best = torch.where(better, logits[..., k], best)
        lane = torch.where(better, k, lane)
    return lane


class DistilledPolicy(VotePolicy):
    """The frozen distilled head (see the module docstring)."""

    name = "distilled"

    def __init__(self, checkpoint: str | None = None):
        self._checkpoint = checkpoint
        self._path = None
        self._params = None
        self._heads: dict[torch.device, DistilledHead] = {}

    def params(self) -> dict:
        """The checkpoint's parameters, loaded once per checkpoint path and
        re-resolved on every call, so the environment override wins even
        when it changes after first use."""
        path = self._checkpoint or checkpoint_path()
        if self._params is None or self._path != path:
            self._params, self._path, self._heads = load_checkpoint(path), path, {}
        return self._params

    def prepare(self) -> None:
        self.params()

    def head(self, device: torch.device) -> DistilledHead:
        """The head of the current checkpoint, on ``device`` (copied there
        once per checkpoint)."""
        params = self.params()
        if device not in self._heads:
            self._heads[device] = head_from_params(params).to(device)
        return self._heads[device]

    def decide_lanes(self, lanes: Lanes, quals, lengths, *, num, den, qual_threshold,
                     qual_cap):
        counts = torch.stack(lanes.counts(), -1)              # (..., L, 5)
        qsums = lane_qsums(lanes, quals)
        head = self.head(counts.device)
        logits = head(features(counts, torch.stack(qsums, -1), lengths, qual_cap=qual_cap))
        base = first_max(logits)
        lengths = torch.as_tensor(lengths).to(counts.device)
        if lengths.dim() < base.dim():
            lengths = lengths[..., None]
        fail = (base == N) | (confidence(logits) < CONFIDENCE_FLOOR) | (lengths <= 0)
        qsum = pick_lane(qsums, base)
        return base.to(torch.uint8), qsum.clamp(max=qual_cap).to(torch.uint8), fail


register_policy(DistilledPolicy())
