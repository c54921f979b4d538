"""The port's vote policies against the JAX package's (CPU).

Seeded numpy inputs go through the JAX policy (its ``decide`` and its
per-family ``family_vote_fn`` under ``jax.vmap``, the program its wires
jit) and through the port's batched counterpart; every output is uint8 or
bool and must be equal, with no tolerance.  Covered: the registry; each
policy's ``decide`` and ``family_vote_fn`` (with and without the QC rider)
on random planes at F 1-16 and L 1-130, the 7/10 boundary, all-low and
all-high families, empty families, PAD members, qualscore 0 and 30 and
first-seen ties; delegation's weight conservation; the distilled
checkpoint (the same bytes, the same refusals, the weights carried
across, the environment override); the wires (``stream_vote`` on every
wire, the dense ``consensus_batch``, the fused ``duplex_batch``) and the
513-member refusal against the JAX programs; and the simulator's degraded
regime.  The CLI end to end is in ``test_torch_policy_e2e.py``.
"""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensuscruncher_tpu.core.consensus_cpu import cutoff_fraction
from consensuscruncher_tpu.ops import consensus_segment as jseg
from consensuscruncher_tpu.ops import consensus_tpu as jtpu
from consensuscruncher_tpu.ops import packing as jpack
from consensuscruncher_tpu.ops.consensus_pallas import duplex_batch_pallas_host
from consensuscruncher_tpu.policies import base as jbase
from consensuscruncher_tpu.policies import delegation as jdelegation
from consensuscruncher_tpu.policies import distilled as jdistilled
from consensuscruncher_tpu.utils import simulate as jsim
from consensuscruncher_tpu_torch import policies as tpol
from consensuscruncher_tpu_torch.ops import consensus_segment as tseg
from consensuscruncher_tpu_torch.ops import consensus_vote
from consensuscruncher_tpu_torch.ops import packing as tpack
from consensuscruncher_tpu_torch.policies import base as tbase
from consensuscruncher_tpu_torch.policies import delegation as tdelegation
from consensuscruncher_tpu_torch.policies import distilled as tdistilled
from consensuscruncher_tpu_torch.utils import simulate as tsim
from consensuscruncher_tpu_torch.utils.phred import N, PAD

POLICIES = ("majority", "delegation", "distilled")


def _batch(rng, nf, fam_cap, length, *, low=0.0, qual_hi=42):
    """``(NF, F, L)`` member planes with PAD past each family's size:
    bases A..N, some PAD cells inside members, quals over [2, qual_hi)
    with a ``low`` share pushed below the delegation threshold."""
    bases = rng.choice(6, (nf, fam_cap, length), p=[.27, .2, .2, .2, .08, .05]).astype(np.uint8)
    quals = rng.integers(2, qual_hi, (nf, fam_cap, length)).astype(np.uint8)
    lowq = rng.random((nf, fam_cap, length)) < low
    quals[lowq] = rng.integers(3, 16, int(lowq.sum()))
    sizes = rng.integers(0, fam_cap + 1, nf).astype(np.int32)
    for i in range(nf):
        bases[i, sizes[i]:] = PAD
        quals[i, sizes[i]:] = 0
    return bases, quals, sizes


def _edge_batch(length=12):
    """Hand-made families: 7 of 10 at the 0.7 boundary (and 6 of 10), an
    all-low and an all-high family, an empty one, a family whose members
    are PAD at some positions, and first-seen ties (two lanes at the top
    count, the earlier member's lane first; and a tie whose earlier voter
    is demoted by the qual threshold)."""
    fam_cap = 10
    bases = np.full((8, fam_cap, length), PAD, np.uint8)
    quals = np.zeros((8, fam_cap, length), np.uint8)
    sizes = np.array([10, 10, 4, 4, 0, 3, 4, 4], np.int32)
    bases[0, :10], quals[0, :10] = 1, 35
    bases[0, :3] = 2                                    # 7 of 10 C
    bases[1, :10], quals[1, :10] = 1, 35
    bases[1, :4] = 2                                    # 6 of 10 C
    bases[2, :4], quals[2, :4] = [[0], [0], [1], [3]], 9        # all low
    bases[3, :4], quals[3, :4] = [[0], [0], [1], [3]], 38       # all high
    bases[5, :3], quals[5, :3] = 2, 30
    bases[5, 1, length // 2:] = PAD                     # PAD inside a member
    bases[6, :4], quals[6, :4] = [[3], [1], [1], [3]], 30       # tie: T first
    bases[7, :4], quals[7, :4] = [[3], [1], [1], [3]], 30
    quals[7, 0] = 5                                     # T's first voter demoted
    quals[2:4, :, ::3] = np.where(bases[2:4, :, ::3] != PAD, 20, 0)   # at the threshold
    return bases, quals, sizes


def _jax_vote(policy, bases, quals, sizes, cfg, with_qc):
    num, den = cutoff_fraction(cfg["cutoff"])
    fn = jbase.get_policy(policy).family_vote_fn(
        num=num, den=den, qual_threshold=cfg["qual_threshold"], qual_cap=cfg["qual_cap"],
        with_qc=with_qc)
    out = jax.jit(jax.vmap(fn))(jnp.asarray(bases), jnp.asarray(quals), jnp.asarray(sizes))
    return [np.asarray(x) for x in out]


def _torch_vote(policy, bases, quals, sizes, cfg, with_qc):
    num, den = cutoff_fraction(cfg["cutoff"])
    fn = tpol.get_policy(policy).family_vote_fn(
        num=num, den=den, qual_threshold=cfg["qual_threshold"], qual_cap=cfg["qual_cap"],
        with_qc=with_qc)
    out = fn(torch.from_numpy(bases), torch.from_numpy(quals), torch.from_numpy(sizes))
    return [x.numpy() for x in out]


CONFIGS = [dict(cutoff=0.7, qual_threshold=0, qual_cap=60),
           dict(cutoff=0.7, qual_threshold=30, qual_cap=60),
           dict(cutoff=0.5, qual_threshold=20, qual_cap=45)]


def test_registry_matches_jax():
    assert tpol.available_policies() == jbase.available_policies() == tuple(sorted(POLICIES))
    assert tpol.DEFAULT_POLICY == jbase.DEFAULT_POLICY == "majority"
    for name in POLICIES:
        assert tpol.get_policy(name).name == name
    with pytest.raises(ValueError) as want:
        jbase.get_policy("bogus")
    with pytest.raises(ValueError) as got:
        tpol.get_policy("bogus")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["q0", "q30", "c05_q20_cap45"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("with_qc", [False, True])
@pytest.mark.parametrize("shape", [(64, 1, 1), (200, 4, 37), (96, 16, 130), (48, 7, 100)])
def test_family_vote_fn_matches_jax(policy, cfg, with_qc, shape):
    nf, fam_cap, length = shape
    rng = np.random.default_rng(nf * 131 + fam_cap * 7 + length)
    bases, quals, sizes = _batch(rng, nf, fam_cap, length, low=0.4)
    want = _jax_vote(policy, bases, quals, sizes, cfg, with_qc)
    got = _torch_vote(policy, bases, quals, sizes, cfg, with_qc)
    assert len(got) == len(want) == (4 if with_qc else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["q0", "q30", "c05_q20_cap45"])
@pytest.mark.parametrize("policy", POLICIES)
def test_family_vote_fn_edges_match_jax(policy, cfg):
    bases, quals, sizes = _edge_batch()
    for with_qc in (False, True):
        want = _jax_vote(policy, bases, quals, sizes, cfg, with_qc)
        got = _torch_vote(policy, bases, quals, sizes, cfg, with_qc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    if cfg["qual_threshold"] == 0 and cfg["cutoff"] == 0.7 and policy != "distilled":
        out_b = got[0]
        assert (out_b[0] == 1).all() and (out_b[1] == N).all()   # 7/10 passes, 6/10 not
        assert (out_b[4] == N).all()                              # empty family


@pytest.mark.parametrize("cfg", CONFIGS, ids=["q0", "q30", "c05_q20_cap45"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("batch", ["random", "edges"])
def test_decide_matches_jax(policy, cfg, batch):
    """The plane protocol itself, one family at a time in JAX, batched in
    the port: the one-hot planes, and the modal lane, the phred and the
    fail mask (before the wire's N/0 masking) equal everywhere."""
    if batch == "random":
        bases, quals, sizes = _batch(np.random.default_rng(11), 40, 8, 29, low=0.5)
    else:
        bases, quals, sizes = _edge_batch(29)
    num, den = cutoff_fraction(cfg["cutoff"])
    qt = cfg["qual_threshold"]
    kw = dict(num=num, den=den, qual_threshold=qt, qual_cap=cfg["qual_cap"])
    jp = jbase.get_policy(policy)
    jplanes = jax.jit(jax.vmap(lambda b, q, s: jbase.family_planes(b, q, s, qual_threshold=qt)))
    jonehot, jmq = jplanes(jnp.asarray(bases), jnp.asarray(quals), jnp.asarray(sizes))
    want = [np.asarray(x) for x in jax.jit(jax.vmap(lambda c, q, s: jp.decide(c, q, s, **kw)))(
        jonehot, jmq, jnp.asarray(sizes))]
    onehot, mq = tbase.family_planes(torch.from_numpy(bases), torch.from_numpy(quals),
                                     torch.from_numpy(sizes), qual_threshold=qt)
    np.testing.assert_array_equal(onehot.numpy(), np.asarray(jonehot))
    np.testing.assert_array_equal(mq.numpy(), np.asarray(jmq))
    got = tpol.get_policy(policy).decide(onehot, mq, torch.from_numpy(sizes), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    one = tpol.get_policy(policy).decide(onehot[3], mq[3], int(sizes[3]), **kw)
    for g, w in zip(one, want):
        np.testing.assert_array_equal(g.numpy(), w[3])


def test_modal_with_tiebreak_matches_jax():
    rng = np.random.default_rng(5)
    votes = rng.random((30, 9, 17, 5)) < 0.15
    modal, top = tbase.modal_with_tiebreak(torch.from_numpy(votes))
    jmodal, jtop = jax.vmap(jbase.modal_with_tiebreak)(jnp.asarray(votes))
    np.testing.assert_array_equal(modal.numpy(), np.asarray(jmodal))
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))


def test_majority_policy_equals_the_kernels_plain_vote():
    """The majority rule over the plane protocol is B1's plain version."""
    assert tpol.majority_family_vote is consensus_vote.vote_members_plain
    rng = np.random.default_rng(8)
    bases, quals, sizes = _batch(rng, 120, 8, 40)
    cfg = consensus_vote.ConsensusConfig(qual_threshold=20)
    got = _torch_vote("majority", bases, quals, sizes,
                      dict(cutoff=0.7, qual_threshold=20, qual_cap=60), False)
    want = consensus_vote.consensus_batch(torch.from_numpy(bases), torch.from_numpy(quals),
                                          sizes, cfg)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


def test_cutoff_guard_matches_jax():
    bases = np.zeros((1, 4, 3), np.uint8)
    for pkg in (jbase, tpol):
        fn = pkg.get_policy("delegation").family_vote_fn(
            num=2**29, den=2**29, qual_threshold=0, qual_cap=60)
        with pytest.raises(ValueError, match="overflow the int32 cutoff compare"):
            if pkg is jbase:
                jax.vmap(fn)(jnp.asarray(bases), jnp.asarray(bases), jnp.ones(1, jnp.int32))
            else:
                fn(torch.from_numpy(bases), torch.from_numpy(bases), torch.ones(1))


def test_delegated_weights_conserve_the_family_total():
    rng = np.random.default_rng(3)
    for fam in (1, 3, 8, 16):
        quals = rng.integers(3, 41, (fam, 50)).astype(np.uint8)
        quals[:, :5] = 10                                 # all-low positions
        member = rng.random((fam, 50)) < 0.9
        got = tdelegation.delegated_weights(torch.from_numpy(quals), torch.from_numpy(member),
                                            fam)
        want = np.asarray(jdelegation.delegated_weights(quals, member, fam))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(got.sum(0).numpy(), member.sum(0), rtol=1e-6)
    assert tdelegation.DELEGATE_THRESHOLD == jdelegation.DELEGATE_THRESHOLD == 20


# ------------------------------------------------------------- distilled


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def test_checkpoint_is_the_reference_bytes(monkeypatch):
    monkeypatch.delenv(tdistilled.CHECKPOINT_ENV, raising=False)
    monkeypatch.delenv(jdistilled.CHECKPOINT_ENV, raising=False)
    port, ref = tdistilled.checkpoint_path(), jdistilled.checkpoint_path()
    assert os.path.dirname(port) != os.path.dirname(ref)
    assert port.startswith(os.path.dirname(os.path.abspath(tpol.__file__)))
    assert _sha(port) == _sha(ref)
    for const in ("CHECKPOINT_ENV", "CONFIDENCE_FLOOR", "FAM_CLIP", "N_FEATURES"):
        assert getattr(tdistilled, const) == getattr(jdistilled, const)


@pytest.mark.parametrize("edit", ["version", "policy", "w1_shape", "b2_shape"])
def test_load_checkpoint_refuses_like_jax(tmp_path, edit):
    with open(tdistilled.checkpoint_path()) as fh:
        doc = json.load(fh)
    if edit == "version":
        doc["version"] = 2
    elif edit == "policy":
        doc["policy"] = "majority"
    elif edit == "w1_shape":
        doc["w1"] = doc["w1"][:-1]
    else:
        doc["b2"] = doc["b2"] + [0.0]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    with pytest.raises(ValueError) as want:
        jdistilled.load_checkpoint(str(bad))
    with pytest.raises(ValueError) as got:
        tdistilled.load_checkpoint(str(bad))
    assert str(got.value) == str(want.value)


def test_head_from_jax_params_matches_jax_forward():
    """The weights carried across exactly, and the head's logits equal to
    JAX's ``forward`` within float32 rounding (the two small products sum
    in another order than XLA's dot; bound set from the dtype, a few ulps
    of logits of magnitude <= 16), with the same argmax everywhere."""
    params = jdistilled.load_checkpoint()
    head = tdistilled.head_from_params(params)
    for key in ("w1", "b1", "w2", "b2"):
        assert getattr(head, key).dtype == torch.float32
        np.testing.assert_array_equal(getattr(head, key).numpy(), params[key])
    rng = np.random.default_rng(17)
    counts = rng.integers(0, 17, (4000, 5)).astype(np.int32)
    lengths = np.maximum(counts.sum(1), rng.integers(0, 17, 4000)).astype(np.int32)
    qsums = (counts * rng.integers(3, 41, (4000, 5))).astype(np.int32)
    feats = jdistilled.features(jnp.asarray(counts), jnp.asarray(qsums), jnp.asarray(lengths),
                                qual_cap=60)
    tfeats = tdistilled.features(torch.from_numpy(counts), torch.from_numpy(qsums),
                                 torch.from_numpy(lengths), qual_cap=60)
    np.testing.assert_array_equal(tfeats.numpy(), np.asarray(feats))
    want = np.asarray(jax.jit(lambda f: jdistilled.forward(params, f))(feats))
    got = head(tfeats).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.finfo(np.float32).eps * 16)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_tanh_is_xla_tanh():
    x = np.random.default_rng(2).standard_normal(200_000).astype(np.float32) * 4
    x[:100] = np.linspace(-1e-3, 1e-3, 100, dtype=np.float32)
    x[100:110] = [0.0, -0.0, 9.0, -9.0, 30.0, -30.0, 7.99, -7.99, 4e-4, -4e-4]
    got = tdistilled.xla_tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jnp.tanh)(x)))


def test_env_override_wins(tmp_path, monkeypatch):
    with open(tdistilled.checkpoint_path()) as fh:
        doc = json.load(fh)
    doc["b2"] = [0.0, 0.0, 0.0, 0.0, 1000.0]              # every position votes N
    other = tmp_path / "other.json"
    other.write_text(json.dumps(doc))
    policy = tpol.get_policy("distilled")
    rng = np.random.default_rng(1)
    bases, quals, sizes = _batch(rng, 20, 4, 10)
    cfg = dict(cutoff=0.7, qual_threshold=0, qual_cap=60)
    before = _torch_vote("distilled", bases, quals, sizes, cfg, False)
    monkeypatch.setenv(tdistilled.CHECKPOINT_ENV, str(other))
    assert tdistilled.checkpoint_path() == str(other)
    assert policy.params()["b2"].tolist() == [0.0, 0.0, 0.0, 0.0, 1000.0]
    after = _torch_vote("distilled", bases, quals, sizes, cfg, False)
    assert (after[0] == N).all() and not (before[0] == N).all()
    monkeypatch.setenv(tdistilled.CHECKPOINT_ENV, str(tmp_path / "missing.json"))
    with pytest.raises(FileNotFoundError):
        policy.prepare()
    monkeypatch.delenv(tdistilled.CHECKPOINT_ENV)
    np.testing.assert_array_equal(_torch_vote("distilled", bases, quals, sizes, cfg,
                                              False)[0], before[0])


# ----------------------------------------------------------------- wires

LEVELS = {"raw": np.arange(2, 42, dtype=np.uint8),
          "pack8": np.array([3, 7, 11, 15, 19, 20, 23, 27, 31, 35, 38, 40], np.uint8),
          "pack6": np.array([4, 9, 14, 18, 20, 22, 26, 30, 33, 36, 39], np.uint8),
          "pack4": np.array([7, 12, 23, 37], np.uint8)}


def _member_stream(wire, seed, width=72, nf=220):
    """``(sizes, lengths, bases, quals)``: a member stream the wire can
    carry (ACGT on the 2-bit wires), families that mostly agree, half the
    members degraded below Phred 20, size-0 families, dead rows at the end
    and each family's true length below the width (dead cells past it)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 12, nf).astype(np.int32)
    sizes[:3] = [0, 1, 16]
    lengths = rng.integers(width // 2, width - 3, nf).astype(np.int32)
    m = int(sizes.sum()) + 5
    top = 4 if wire in ("pack4", "pack6") else 6
    bases = rng.integers(0, top, (m, width), dtype=np.uint8)
    levels = LEVELS[wire]
    quals = rng.choice(levels[levels >= 20], (m, width)).astype(np.uint8)
    low = rng.random(m) < 0.5
    quals[low] = rng.choice(levels[levels < 20], (int(low.sum()), width))
    start = 0
    for size in sizes:
        if size:
            keep = rng.random((size, width)) < 0.75
            bases[start:start + size] = np.where(keep, bases[start], bases[start:start + size])
        start += size
    return sizes, lengths, bases, quals


def _jax_wire(wire, bases, quals):
    if wire == "raw":
        return bases, quals
    if wire == "pack4":
        book = jpack.build_codebook4(quals)
        return jpack.pack4(bases, quals, book), book
    book = jpack.build_codebook(quals)
    return (jpack.pack if wire == "pack8" else jpack.pack6)(bases, quals, book), book


def _port_cfg(cfg):
    return consensus_vote.ConsensusConfig(cutoff=cfg["cutoff"],
                                          qual_threshold=cfg["qual_threshold"],
                                          qual_cap=cfg["qual_cap"])


@pytest.mark.parametrize("with_qc", [False, True])
@pytest.mark.parametrize("cfg", CONFIGS[::2], ids=["q0", "c05_q20_cap45"])
@pytest.mark.parametrize("policy", ["delegation", "distilled"])
@pytest.mark.parametrize("wire", tpack.WIRES)
def test_stream_vote_matches_jax(wire, policy, cfg, with_qc):
    sizes, lengths, bases, quals = _member_stream(wire, tpack.WIRES.index(wire) + 3)
    out_len = -(-int(lengths.max()) // 8) * 8
    num, den = cutoff_fraction(cfg["cutoff"])
    fn = jseg._compiled_stream_vote(wire, num, den, cfg["qual_threshold"], cfg["qual_cap"],
                                    jseg.pick_member_cap(sizes), out_len, with_qc, policy)
    jargs = _jax_wire(wire, bases, quals)
    want = fn(*jargs, sizes, lengths) if with_qc else fn(*jargs, sizes)
    a, b = tpack.encode_wire(wire, bases, quals)
    got = tseg.stream_vote(wire, torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(sizes), _port_cfg(cfg), out_len,
                           torch.from_numpy(lengths) if with_qc else None, policy=policy)
    if with_qc:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        # the rider is the majority kernel's, whatever the policy
        majority = tseg.stream_vote(wire, torch.from_numpy(a), torch.from_numpy(b), sizes,
                                    _port_cfg(cfg), out_len, torch.from_numpy(lengths))
        assert torch.equal(majority[1], got[1])
        got = got[0]
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0] != N).any() and (got[0] == N).any()


@pytest.mark.parametrize("policy", ["delegation", "distilled"])
def test_stream_vote_refuses_a_family_over_the_gather_cap(policy):
    sizes = np.array([2, 513, 1], np.int32)
    bases = np.zeros((516, 8), np.uint8)
    quals = np.full((516, 8), 30, np.uint8)
    assert jseg.pick_member_cap(sizes) is tseg.pick_member_cap(sizes) is None
    with pytest.raises(ValueError) as want:
        jseg._compiled_stream_vote("raw", 7, 10, 0, 60, None, None, False, policy)
    with pytest.raises(ValueError) as got:
        tseg.stream_vote("raw", torch.from_numpy(bases), torch.from_numpy(quals), sizes,
                         policy=policy)
    assert str(got.value) == str(want.value)
    assert "MAX_DENSE_CAP=512" in str(got.value)
    # 512 members still vote, and majority takes any size
    sizes[1] = 512
    tseg.stream_vote("raw", torch.from_numpy(bases), torch.from_numpy(quals), sizes,
                     policy=policy)
    sizes[1] = 513
    tseg.stream_vote("raw", torch.from_numpy(bases), torch.from_numpy(quals), sizes)


def test_stream_vote_without_members():
    got = tseg.stream_vote("raw", torch.zeros((0, 8), dtype=torch.uint8),
                           torch.zeros((0, 8), dtype=torch.uint8), np.zeros(3, np.int32),
                           out_len=8, qc_lengths=torch.full((3,), 8), policy="distilled")
    assert (got[0][0] == N).all() and (got[0][1] == 0).all() and (got[1] == 0).all()


@pytest.mark.parametrize("with_qc", [False, True])
@pytest.mark.parametrize("cfg", CONFIGS, ids=["q0", "q30", "c05_q20_cap45"])
@pytest.mark.parametrize("policy", ["delegation", "distilled"])
def test_dense_consensus_batch_matches_jax(policy, cfg, with_qc):
    bases, quals, sizes = _batch(np.random.default_rng(21), 160, 8, 96, low=0.5)
    num, den = cutoff_fraction(cfg["cutoff"])
    want = jtpu._compiled_batch_fn(num, den, cfg["qual_threshold"], cfg["qual_cap"], with_qc,
                                   policy)(jnp.asarray(bases), jnp.asarray(quals),
                                           jnp.asarray(sizes))
    got = consensus_vote.consensus_batch(torch.from_numpy(bases), torch.from_numpy(quals),
                                         sizes, _port_cfg(cfg), qc=with_qc, policy=policy)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if with_qc:
        np.testing.assert_array_equal(got[2].numpy(), np.stack([want[2], want[3]]))
        # the dense rider is B1 dense's, whatever the policy
        majority = consensus_vote.consensus_batch(torch.from_numpy(bases),
                                                  torch.from_numpy(quals), sizes,
                                                  _port_cfg(cfg), qc=True)
        assert torch.equal(majority[2], got[2])


@pytest.mark.parametrize("policy", ["delegation", "distilled"])
def test_duplex_batch_matches_jax(policy):
    rng = np.random.default_rng(31)
    ba, qa, sa = _batch(rng, 120, 6, 40, low=0.5)
    bb, qb, sb = _batch(rng, 120, 6, 40, low=0.5)
    sa[:5], sb[5:10] = 0, 0
    cfg = dict(cutoff=0.7, qual_threshold=0, qual_cap=60)
    prev = jbase.installed_vote_policy()
    jbase.set_vote_policy(policy)
    try:
        want = duplex_batch_pallas_host(ba, qa, sa, bb, qb, sb, jtpu.ConsensusConfig())
    finally:
        jbase.set_vote_policy(prev)
    got = consensus_vote.duplex_batch(*(torch.from_numpy(x) for x in (ba, qa)), sa,
                                      *(torch.from_numpy(x) for x in (bb, qb)), sb,
                                      _port_cfg(cfg), policy=policy)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[4] != N).any()
    # the fused kernel's majority stays where it was
    majority = consensus_vote.duplex_batch(*(torch.from_numpy(x) for x in (ba, qa)), sa,
                                           *(torch.from_numpy(x) for x in (bb, qb)), sb)
    assert not all(torch.equal(g, m) for g, m in zip(got, majority))


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_simulate_bam_matches_jax(tmp_path, rate):
    kw = dict(n_fragments=150, seed=7, degraded_read_rate=rate)
    want = jsim.simulate_bam(str(tmp_path / "jax.bam"), jsim.SimConfig(**kw))
    got = tsim.simulate_bam(str(tmp_path / "torch.bam"), tsim.SimConfig(**kw))
    assert got.family_sizes == want.family_sizes and got.molecules == want.molecules
    assert _sha(tmp_path / "torch.bam") == _sha(tmp_path / "jax.bam")
    for key in ("degraded_read_rate", "degraded_error_rate", "degraded_qual"):
        assert getattr(tsim.SimConfig(), key) == getattr(jsim.SimConfig(), key)
