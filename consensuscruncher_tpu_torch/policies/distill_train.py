"""Train the distilled consensus-policy head and write its checkpoint.

Port of the JAX package's ``tools/distill_train.py``:

    python -m consensuscruncher_tpu_torch.policies.distill_train \
        [--out PATH] [--seed 17] [--samples 120000] [--hidden 16] \
        [--steps 400] [--lr 0.01] [--device cuda|cpu]

The teacher is the simulator's ground truth: every synthetic family
position has a known molecule base.  The student is the per-position head
of :mod:`policies.distilled`.  The data are per-position count/qual planes
made with the error model of ``utils.simulate`` (each member's substitution
probability follows its Phred, inflated by a per-regime miscalibration
factor for degraded reads), mixed across clean, mixed-quality and heavily
degraded regimes.  The planes, the split and the initial weights come from
one numpy generator in the reference tool's call order, so one seed gives
the reference's data bit for bit.

Training is full-batch Adam written out as the reference writes it, on the
gradients of ``torch.autograd.grad`` through :func:`distilled.forward`
(whose ``tanh`` carries the JAX package's derivative rule).  Every float32
operation is elementwise or a float64 product; TF32 is off while a run
trains.  The document equals the reference tool's in its keys, rounding
and layout; its ``meta.tool`` names this module.

The default ``--out`` is this package's committed checkpoint, as the
reference tool's is its own: pass ``--out`` to keep the committed file.
The default device is the CUDA card; without one the run raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from consensuscruncher_tpu_torch.device import resolve_device
from consensuscruncher_tpu_torch.policies import distilled

TOOL = "consensuscruncher_tpu_torch/policies/distill_train.py"

#: Training regimes: fraction of degraded members, their Phred band, and
#: how much worse than their Phred claims they really are.
REGIMES = (
    {"name": "clean", "lowq_fraction": 0.0, "lowq_band": (5, 16),
     "healthy_band": (25, 41), "miscal": 1.0},
    {"name": "mixed", "lowq_fraction": 0.5, "lowq_band": (5, 16),
     "healthy_band": (25, 41), "miscal": 3.0},
    {"name": "degraded", "lowq_fraction": 0.8, "lowq_band": (5, 16),
     "healthy_band": (25, 41), "miscal": 5.0},
)

QUAL_CAP = 60
MAX_FAM = 16

# Adam's constants, as the reference writes them
B1, B2, EPS = 0.9, 0.999, 1e-8


def synth_positions(rng, n, regime):
    """Fabricate ``n`` independent family positions under one regime.

    Returns ``(counts (n,5) int32, qsums (n,5) int32, fam (n,) int32,
    labels (n,) int32)``: the planes the vote hands ``decide``, one
    position per row, with the truth base as the label.
    """
    fam = np.maximum(1, rng.poisson(3.0, n)).astype(np.int32)
    fam = np.minimum(fam, MAX_FAM)
    truth = rng.integers(0, 4, n).astype(np.int32)
    counts = np.zeros((n, 5), np.int32)
    qsums = np.zeros((n, 5), np.int32)
    member = np.arange(MAX_FAM)[None, :] < fam[:, None]  # (n, F)
    degraded = member & (rng.random((n, MAX_FAM)) < regime["lowq_fraction"])
    lo, hi = regime["lowq_band"]
    hlo, hhi = regime["healthy_band"]
    quals = np.where(degraded,
                     rng.integers(lo, hi, (n, MAX_FAM)),
                     rng.integers(hlo, hhi, (n, MAX_FAM))).astype(np.int32)
    # substitution probability from the member's own Phred, inflated by
    # the regime's miscalibration factor for degraded members
    p_err = np.power(10.0, -quals / 10.0)
    p_err = np.minimum(0.75, np.where(degraded, p_err * regime["miscal"], p_err))
    err = member & (rng.random((n, MAX_FAM)) < p_err)
    delta = rng.integers(1, 4, (n, MAX_FAM)).astype(np.int32)
    bases = np.where(err, (truth[:, None] + delta) % 4, truth[:, None])
    bases = np.where(member, bases, 4)  # non-members park on a dead lane
    for lane in range(4):
        hit = member & (bases == lane)
        counts[:, lane] = hit.sum(axis=1)
        qsums[:, lane] = np.where(hit, quals, 0).sum(axis=1)
    return counts, qsums, fam, truth


def majority_accuracy(counts, labels):
    """Baseline: the fraction of positions where the plain modal base is
    the truth (ties toward the lower lane; per-position planes carry no
    member order for the vote's first-seen tie-break)."""
    modal = counts[:, :4].argmax(axis=1)
    return float((modal == labels).mean())


def init_params(rng, hidden):
    def glorot(shape):
        scale = np.sqrt(2.0 / sum(shape))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "w1": glorot((distilled.N_FEATURES, hidden)),
        "b1": np.zeros(hidden, np.float32),
        "w2": glorot((hidden, 5)),
        "b2": np.zeros(5, np.float32),
    }


def make_data(seed: int, samples: int):
    """The regime mix of ``samples`` positions and the generator that made
    it (the split and the initial weights draw from it next)."""
    rng = np.random.default_rng(seed)
    per = samples // len(REGIMES)
    planes = [synth_positions(rng, per, reg) for reg in REGIMES]
    counts, qsums, fam, labels = (np.concatenate([p[i] for p in planes]) for i in range(4))
    return rng, per, counts, qsums, fam, labels


def split(rng, n: int):
    """The shuffled ``(hold, train)`` index split; the holdout keeps regime
    provenance through the pre-shuffle index."""
    order = rng.permutation(n)
    n_hold = n // 5
    return order[:n_hold], order[n_hold:]


def loss_and_grads(params: dict, x: torch.Tensor, y: torch.Tensor):
    """The mean cross-entropy of the head on ``(x, y)`` and its gradient
    in each parameter."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    logp = torch.log_softmax(distilled.forward(leaves, x), 1)
    loss = -logp.gather(1, y[:, None]).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 tensor on ``like``'s device: a divisor the
    card divides by, where a host scalar would be a reciprocal multiply."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def adam_step(params: dict, m: dict, v: dict, step: int, x, y, lr: float) -> torch.Tensor:
    """One full-batch Adam step (``step`` counts from 1), in place on
    ``params``, ``m`` and ``v``; returns the loss before the step."""
    loss, grads = loss_and_grads(params, x, y)
    for k in params:
        m[k] = B1 * m[k] + (1 - B1) * grads[k]
        v[k] = B2 * v[k] + (1 - B2) * grads[k] ** 2
        mh = m[k] / _scalar(1 - B1 ** step, m[k])
        vh = v[k] / _scalar(1 - B2 ** step, v[k])
        params[k] = params[k] - lr * mh / (torch.sqrt(vh) + EPS)
    return loss


@contextlib.contextmanager
def highest_precision():
    """float32 products at full precision (no TF32) for the block's
    duration; the previous settings come back after it."""
    matmul = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn


def train(args):
    """Train on ``args.device`` (default the card).  Returns the float32
    parameters as numpy arrays and the held-out accuracy per regime."""
    dev = resolve_device(getattr(args, "device", None))
    rng, per, counts, qsums, fam, labels = make_data(args.seed, args.samples)
    with highest_precision():
        feats = distilled.features(torch.from_numpy(counts).to(dev),
                                   torch.from_numpy(qsums).to(dev),
                                   torch.from_numpy(fam).to(dev), qual_cap=QUAL_CAP)
        hold, tr = split(rng, len(feats))
        x_tr = feats[torch.from_numpy(tr).to(dev)]
        y_tr = torch.from_numpy(labels[tr]).to(dev, torch.int64)
        params = {k: torch.from_numpy(p).to(dev)
                  for k, p in init_params(rng, args.hidden).items()}
        m = {k: torch.zeros_like(p) for k, p in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
        for step in range(1, args.steps + 1):
            loss = adam_step(params, m, v, step, x_tr, y_tr, args.lr)
            if step % 100 == 0 or step == 1:
                print(f"distill_train: step {step} loss {float(loss):.4f}",
                      file=sys.stderr, flush=True)
        with torch.no_grad():
            logits = distilled.forward(params, feats[torch.from_numpy(hold).to(dev)])
        pred = distilled.first_max(logits).cpu().numpy()
    accuracy = {}
    for i, reg in enumerate(REGIMES):
        in_reg = (hold >= i * per) & (hold < (i + 1) * per)
        idx = hold[in_reg]
        accuracy[reg["name"]] = {
            "distilled": float((pred[in_reg] == labels[idx]).mean()),
            "majority": majority_accuracy(counts[idx], labels[idx]),
            "n": int(in_reg.sum()),
        }
        print(f"distill_train: holdout[{reg['name']}] "
              f"distilled={accuracy[reg['name']]['distilled']:.4f} "
              f"majority={accuracy[reg['name']]['majority']:.4f}",
              file=sys.stderr, flush=True)
    return {k: p.cpu().numpy() for k, p in params.items()}, accuracy


def checkpoint_doc(args, params: dict, accuracy: dict) -> dict:
    """The checkpoint document of a run (the reference tool's layout)."""
    return {
        "version": 1,
        "policy": "distilled",
        "w1": [[round(float(x), 6) for x in row] for row in params["w1"]],
        "b1": [round(float(x), 6) for x in params["b1"]],
        "w2": [[round(float(x), 6) for x in row] for row in params["w2"]],
        "b2": [round(float(x), 6) for x in params["b2"]],
        "meta": {
            "tool": TOOL,
            "seed": args.seed,
            "samples": args.samples,
            "hidden": args.hidden,
            "steps": args.steps,
            "lr": args.lr,
            "qual_cap": QUAL_CAP,
            "regimes": [r["name"] for r in REGIMES],
            "holdout_accuracy": {
                name: {k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in row.items()}
                for name, row in accuracy.items()},
        },
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(distilled.__file__)), "checkpoints",
        distilled.CHECKPOINT_NAME))
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--samples", type=int, default=120_000,
                    help="total positions across the regime mix")
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    params, accuracy = train(args)
    doc = checkpoint_doc(args, params, accuracy)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"distill_train: wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
