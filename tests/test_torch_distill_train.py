"""The port's trainer of the distilled head against the JAX package's
``tools/distill_train.py`` (CPU).

The JAX tool is loaded from its path and run as it stands; its jitted
``value_and_grad`` is observed by wrapping ``jax.jit`` for the call, which
records every step's loss (and the gradients at initialisation).  The
port's steps are observed by wrapping ``distill_train.loss_and_grads``.

Held: the data, the split and the initial weights bit for bit; the
features and ``tanh`` and its derivative bit for bit; the logits within
float32 rounding (XLA's float32 dot rounds its sums otherwise than the
head's float64 accumulation); the loss at initialisation to 1e-6
relative and the gradients to 1e-6 absolute; every step's loss to 1e-5
relative and the final weights to 1e-5 on a cut run (12,000 samples, 60
steps); at the committed defaults the document against the JAX tool's run
and against the committed checkpoint (every weight within 1e-4, every
held-out accuracy within 0.001 and every ``n`` exact, distilled above
majority on ``mixed`` and ``degraded``, everything else equal but
``meta.tool``); the refusal without CUDA; the committed checkpoints
unchanged.
"""

import argparse
import contextlib
import hashlib
import importlib.util
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensuscruncher_tpu.policies import distilled as jdistilled
from consensuscruncher_tpu_torch.policies import distill_train as tdt
from consensuscruncher_tpu_torch.policies import distilled as tdistilled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "distill_train.py")
CHECKPOINTS = tuple(
    os.path.join(os.path.dirname(os.path.abspath(pkg.__file__)), "checkpoints",
                 pkg.CHECKPOINT_NAME) for pkg in (tdistilled, jdistilled))

WEIGHT_TOL = 1e-4       # the document's weights at the defaults
ACCURACY_TOL = 1e-3     # its held-out accuracies
CUT_TOL = 1e-5          # every step's loss (relative) and the weights on the cut run
INIT_LOSS_RTOL, INIT_GRAD_ATOL = 1e-6, 1e-6
# logits of magnitude <= 16 within a few float32 ulps (see the module docstring)
LOGIT_ATOL = 4 * np.finfo(np.float32).eps * 16
CUT = dict(samples=12_000, steps=60)
DEFAULTS = dict(seed=17, samples=120_000, hidden=16, steps=400, lr=0.01)


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


COMMITTED = {path: _sha(path) for path in CHECKPOINTS}


def _jax_tool():
    spec = importlib.util.spec_from_file_location("reference_distill_train", JAX_TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JDT = _jax_tool()


def _args(**kw) -> argparse.Namespace:
    return argparse.Namespace(**{**DEFAULTS, "device": "cpu", **kw})


@contextlib.contextmanager
def _jax_steps(calls: list):
    """Record each call of the JAX tool's jitted ``value_and_grad`` as
    ``(loss, grads)``."""
    real = jax.jit

    def recording(fn, *a, **k):
        compiled = real(fn, *a, **k)

        def call(*args):
            loss, grads = compiled(*args)
            calls.append((float(loss), {key: np.asarray(g) for key, g in grads.items()}))
            return loss, grads
        return call

    jax.jit = recording
    try:
        yield
    finally:
        jax.jit = real


@contextlib.contextmanager
def _port_steps(losses: list):
    real = tdt.loss_and_grads

    def recording(params, x, y):
        loss, grads = real(params, x, y)
        losses.append(float(loss))
        return loss, grads

    tdt.loss_and_grads = recording
    try:
        yield
    finally:
        tdt.loss_and_grads = real


def _run(main, argv, steps_ctx, record) -> tuple[dict, list]:
    """``main(argv)`` with its stderr captured: the document and the
    stderr lines."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), steps_ctx(record):
        assert main(argv) == 0
    out = argv[argv.index("--out") + 1]
    with open(out) as fh:
        text = fh.read()
    assert text.endswith("}\n")
    doc = json.loads(text)
    assert text == json.dumps(doc, indent=1, sort_keys=True) + "\n"
    return doc, err.getvalue().splitlines()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch's intra-op pool held to one thread for this module, then
    restored.  The port's trainer at the defaults takes ~18 s on 8 CPU
    cores and ~97 s on one, but beside five busy test processes
    (the suite's parallel run) its parallel regions stall on descheduled
    threads: 298 s on 2 threads, 418 s for the fixture on 8, against 250 s
    on one.  Module-wide, since the loss's float32 sums follow the thread
    count and the tests recompute it against ``default_runs``."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def default_runs(tmp_path_factory):
    """Both tools at the committed defaults (the port on the CPU)."""
    tmp = tmp_path_factory.mktemp("distill")
    jax_calls, port_losses = [], []
    jdoc, jerr = _run(JDT.main, ["--out", str(tmp / "jax.json")], _jax_steps, jax_calls)
    tdoc, terr = _run(tdt.main, ["--out", str(tmp / "port.json"), "--device", "cpu"],
                      _port_steps, port_losses)
    return {"jax": jdoc, "port": tdoc, "jax_err": jerr, "port_err": terr,
            "jax_calls": jax_calls, "port_losses": port_losses}


def test_data_split_and_init_are_the_reference_bits():
    args = _args()
    rng, per, counts, qsums, fam, labels = tdt.make_data(args.seed, args.samples)
    jrng = np.random.default_rng(args.seed)
    assert per == args.samples // len(JDT.REGIMES)
    jplanes = [JDT.synth_positions(jrng, per, reg) for reg in JDT.REGIMES]
    for got, i in ((counts, 0), (qsums, 1), (fam, 2), (labels, 3)):
        want = np.concatenate([p[i] for p in jplanes])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    hold, tr = tdt.split(rng, len(counts))
    order = jrng.permutation(len(counts))
    np.testing.assert_array_equal(hold, order[:len(counts) // 5])
    np.testing.assert_array_equal(tr, order[len(counts) // 5:])
    got, want = tdt.init_params(rng, args.hidden), JDT.init_params(jrng, args.hidden)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key])
    assert tdt.REGIMES == JDT.REGIMES
    assert (tdt.QUAL_CAP, tdt.MAX_FAM) == (JDT.QUAL_CAP, JDT.MAX_FAM)
    assert tdt.majority_accuracy(counts, labels) == JDT.majority_accuracy(counts, labels)


def _synthetic_features(samples=24_000):
    _, _, counts, qsums, fam, labels = tdt.make_data(17, samples)
    jfeats = np.asarray(jdistilled.features(jnp.asarray(counts), jnp.asarray(qsums),
                                            jnp.asarray(fam), qual_cap=tdt.QUAL_CAP))
    tfeats = tdistilled.features(torch.from_numpy(counts), torch.from_numpy(qsums),
                                 torch.from_numpy(fam), qual_cap=tdt.QUAL_CAP)
    np.testing.assert_array_equal(tfeats.numpy(), jfeats)
    return jfeats, tfeats, labels


@pytest.mark.parametrize("weights", ["checkpoint", "init"])
def test_forward_matches_jax_forward(weights):
    jfeats, tfeats, _ = _synthetic_features()
    if weights == "checkpoint":
        params = {k: v for k, v in jdistilled.load_checkpoint().items() if k != "meta"}
    else:
        params = JDT.init_params(np.random.default_rng(3), 16)
    want = np.asarray(jax.jit(jdistilled.forward)(params, jfeats))
    got = tdistilled.forward(params, tfeats)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(tdistilled.first_max(got).numpy(), want.argmax(1))
    # the inference head is this function with its weights frozen
    head = tdistilled.head_from_params(params)
    assert torch.equal(head(tfeats), got)
    if weights == "checkpoint":
        path = jdistilled.checkpoint_path()
        assert torch.equal(tdistilled.checkpoint_forward(jfeats, path), got)
        assert torch.equal(tdistilled.checkpoint_forward(tfeats), got)
        np.testing.assert_allclose(
            tdistilled.checkpoint_forward(jfeats).numpy(),
            np.asarray(jdistilled.checkpoint_forward(jfeats, path)), rtol=0, atol=LOGIT_ATOL)


def test_tanh_derivative_is_jax_rule():
    x = np.concatenate([np.linspace(-9, 9, 100_001, dtype=np.float32),
                        np.linspace(-1e-3, 1e-3, 1001, dtype=np.float32),
                        np.float32([0.0, -0.0, 4e-4, -4e-4, 7.99, -7.99, 30.0, -30.0])])
    want = np.asarray(jax.jit(jax.vmap(jax.grad(jnp.tanh)))(x))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(tdistilled._Tanh.apply(xt).sum(), xt)
    np.testing.assert_array_equal(got.numpy(), want)
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, g: jax.vjp(jnp.tanh, x)[1](g)[0])(x, g))
    (got,) = torch.autograd.grad(tdistilled._Tanh.apply(xt), xt, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.no_grad():
        np.testing.assert_array_equal(tdistilled._Tanh.apply(xt).numpy(),
                                      np.asarray(jax.jit(jnp.tanh)(x)))


def _port_init(args):
    rng, _, counts, qsums, fam, labels = tdt.make_data(args.seed, args.samples)
    feats = tdistilled.features(torch.from_numpy(counts), torch.from_numpy(qsums),
                                torch.from_numpy(fam), qual_cap=tdt.QUAL_CAP)
    _, tr = tdt.split(rng, len(feats))
    params = {k: torch.from_numpy(v) for k, v in tdt.init_params(rng, args.hidden).items()}
    return params, feats[torch.from_numpy(tr)], torch.from_numpy(labels[tr]).long()


def test_loss_and_gradients_at_init_match_jax(default_runs):
    loss, grads = tdt.loss_and_grads(*_port_init(_args()))
    jloss, jgrads = default_runs["jax_calls"][0]
    assert abs(float(loss) - jloss) <= INIT_LOSS_RTOL * abs(jloss)
    assert grads.keys() == jgrads.keys()
    for key, want in jgrads.items():
        assert grads[key].dtype == torch.float32
        np.testing.assert_allclose(grads[key].numpy(), want, rtol=0, atol=INIT_GRAD_ATOL)
    assert float(loss) == default_runs["port_losses"][0]


def test_cut_run_follows_jax_step_by_step():
    args = _args(**CUT)
    jcalls, tlosses = [], []
    with contextlib.redirect_stderr(io.StringIO()):
        with _jax_steps(jcalls):
            jparams, jacc = JDT.train(args)
        with _port_steps(tlosses):
            tparams, tacc = tdt.train(args)
    assert len(jcalls) == len(tlosses) == CUT["steps"]
    jl = np.array([c[0] for c in jcalls])
    np.testing.assert_allclose(np.array(tlosses), jl, rtol=CUT_TOL, atol=0)
    assert tparams.keys() == jparams.keys()
    for key in jparams:
        assert tparams[key].dtype == np.float32
        np.testing.assert_allclose(tparams[key], jparams[key], rtol=0, atol=CUT_TOL)
    for name, row in jacc.items():
        assert tacc[name]["n"] == row["n"]
        assert abs(tacc[name]["distilled"] - row["distilled"]) <= ACCURACY_TOL
        assert tacc[name]["majority"] == row["majority"]


def _weights_diff(got: dict, want: dict) -> float:
    return max(float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k])).max())
               for k in ("w1", "b1", "w2", "b2"))


def _held_to(got: dict, want: dict, tool: str) -> None:
    """``got`` (a port document) against ``want`` at the stated tolerances."""
    assert got.keys() == want.keys()
    for key in ("w1", "b1", "w2", "b2"):
        assert np.shape(got[key]) == np.shape(want[key])
    assert _weights_diff(got, want) <= WEIGHT_TOL
    assert got["meta"]["tool"] == tdt.TOOL and want["meta"]["tool"] == tool
    gacc, wacc = got["meta"]["holdout_accuracy"], want["meta"]["holdout_accuracy"]
    assert gacc.keys() == wacc.keys() == {"clean", "mixed", "degraded"}
    for name, row in wacc.items():
        assert gacc[name]["n"] == row["n"]
        for key in ("distilled", "majority"):
            assert abs(gacc[name][key] - row[key]) <= ACCURACY_TOL
    for name in ("mixed", "degraded"):
        assert gacc[name]["distilled"] > gacc[name]["majority"]
    rest = {k: v for k, v in got["meta"].items() if k not in ("tool", "holdout_accuracy")}
    assert rest == {k: v for k, v in want["meta"].items()
                    if k not in ("tool", "holdout_accuracy")}
    assert {k: v for k, v in got.items() if k not in ("w1", "b1", "w2", "b2", "meta")} == \
        {k: v for k, v in want.items() if k not in ("w1", "b1", "w2", "b2", "meta")}


def test_defaults_match_the_jax_run(default_runs):
    jdoc, tdoc = default_runs["jax"], default_runs["port"]
    _held_to(tdoc, jdoc, "tools/distill_train.py")
    # every step's loss, as on the cut run
    jl = np.array([c[0] for c in default_runs["jax_calls"]])
    np.testing.assert_allclose(np.array(default_runs["port_losses"]), jl, rtol=CUT_TOL, atol=0)
    # the progress lines: the same lines, their numbers within the tolerances
    number = re.compile(r"\d+\.\d+")
    jerr, terr = default_runs["jax_err"], default_runs["port_err"]
    assert len(jerr) == len(terr) == 9
    for jline, tline in zip(jerr[:-1], terr[:-1]):
        assert number.sub("#", jline) == number.sub("#", tline)
        for a, b in zip(number.findall(jline), number.findall(tline)):
            assert abs(float(a) - float(b)) <= ACCURACY_TOL
    assert terr[-1].startswith("distill_train: wrote ")


def test_defaults_match_the_committed_checkpoint(default_runs):
    with open(CHECKPOINTS[0]) as fh:
        committed = json.load(fh)
    _held_to(default_runs["port"], committed, "tools/distill_train.py")
    # the JAX tool's own run is not the committed file byte for byte either
    assert _weights_diff(default_runs["jax"], committed) <= WEIGHT_TOL


def test_trained_checkpoint_loads_as_a_policy(default_runs, tmp_path):
    path = tmp_path / "trained.json"
    path.write_text(json.dumps(default_runs["port"]))
    params = tdistilled.load_checkpoint(str(path))
    assert params["meta"]["tool"] == tdt.TOOL
    policy = tdistilled.DistilledPolicy(checkpoint=str(path))
    assert policy.params()["w1"].shape == (tdistilled.N_FEATURES, DEFAULTS["hidden"])


def test_the_card_is_the_default_and_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.json"
    assert tdt.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdt.main(["--out", str(out), "--samples", "300", "--steps", "1"])
    assert not out.exists()
    assert tdt.build_parser().parse_args([]).out == CHECKPOINTS[0]


def test_no_float32_matmul_setting_leaks():
    before = torch.get_float32_matmul_precision()
    with contextlib.redirect_stderr(io.StringIO()):
        tdt.train(_args(samples=600, steps=2))
    assert torch.get_float32_matmul_precision() == before


def test_committed_checkpoints_are_unchanged():
    assert {path: _sha(path) for path in CHECKPOINTS} == COMMITTED
    assert len(set(COMMITTED.values())) == 1
