"""``parallel/mesh.py`` of the port against the JAX package's (CPU).

The JAX functions run on the conftest's 8 virtual CPU devices; the port's
on meshes of repeated ``cpu`` shards, each voted by the kernels' plain
versions.  Same seeded numpy inputs, mesh sizes 1, 2, 4 and 8, exact
outputs: equal bytes and equal stats.

- ``make_mesh`` sizes and its refusal; ``device_mesh`` lays N shards over
  fewer cards (one stderr line) and raises without a card;
- ``pad_batch_to_mesh``, ``StepStats.from_vector``;
- ``sharded_consensus_batch`` with and without ``lengths``, and with fewer
  families than shards;
- ``plan_member_shards`` (cuts, ``nf_local``, ``m_local``, ``order()``) and
  ``stack_member_shards``;
- ``stream_vote_sharded`` on every wire, whole planes in the stacked
  order;
- ``duplex_batch_host_sharded``;
- ``full_pipeline_step``, ``packed_pipeline_step`` and
  ``packed4_pipeline_step`` on the cases of ``tests/test_mesh.py`` and
  ``tests/test_packing.py``;
- the launch guard: a ``TileLaunch`` on planes of ``cuda:1`` launches with
  ``cuda:1`` current, on ``cuda:1``'s stream, and sizes its grid there.
"""

import dataclasses

import numpy as np
import pytest
import torch

from consensuscruncher_tpu.ops import packing as jpack
from consensuscruncher_tpu.ops.consensus_tpu import ConsensusConfig as JaxConfig
from consensuscruncher_tpu.ops.duplex_tpu import duplex_batch_host as jax_duplex_batch_host
from consensuscruncher_tpu.parallel import mesh as jm
from consensuscruncher_tpu_torch.ops import consensus_vote
from consensuscruncher_tpu_torch.ops import packing as tpack
from consensuscruncher_tpu_torch.parallel import mesh as tm
from consensuscruncher_tpu_torch.utils.phred import N, PAD

CPU = torch.device("cpu")
SIZES = (1, 2, 4, 8)
BINNED = np.array([2, 12, 23, 37], np.uint8)  # tests/test_packing.py's NovaSeq bins


def _meshes(n):
    return jm.make_mesh(n), tm.make_mesh(devices=[CPU] * n)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _strand(rng, batch, fam, length, min_size=1, qual_lo=2):
    """The JAX tests' strand: PAD and qual 0 in each family's unused slots."""
    bases = rng.integers(0, 4, (batch, fam, length)).astype(np.uint8)
    quals = rng.integers(qual_lo, 41, (batch, fam, length)).astype(np.uint8)
    sizes = rng.integers(min_size, fam + 1, (batch,)).astype(np.int32)
    for i in range(batch):
        bases[i, sizes[i]:] = PAD
        quals[i, sizes[i]:] = 0
    return bases, quals, sizes


def _binned_strand(rng, batch, fam, length):
    """``tests/test_packing.py``'s strand: binned quals, and PAD slots with
    a qual the codebook holds."""
    bases = rng.integers(0, 4, (batch, fam, length)).astype(np.uint8)
    quals = BINNED[rng.integers(0, len(BINNED), (batch, fam, length))]
    sizes = rng.integers(1, fam + 1, (batch,)).astype(np.int32)
    for i in range(batch):
        bases[i, sizes[i]:] = PAD
        quals[i, sizes[i]:] = 2
    return bases, quals, sizes


def _same(ours, theirs):
    assert len(ours) == len(theirs)
    for got, want in zip(ours, theirs):
        got, want = _np(got), _np(want)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_make_mesh_sizes_and_refusal():
    devs = [CPU] * 8
    for n in SIZES:
        assert tm.make_mesh(n, devices=devs).size == jm.make_mesh(n).devices.size == n
    assert tm.make_mesh(devices=devs).size == jm.make_mesh().devices.size == 8
    with pytest.raises(ValueError) as ours:
        tm.make_mesh(64, devices=devs)
    with pytest.raises(ValueError) as theirs:
        jm.make_mesh(64)
    assert str(ours.value) == str(theirs.value)
    assert tm.FAMILY_AXIS == jm.FAMILY_AXIS


def test_device_mesh_lays_shards_over_the_cards(monkeypatch, capsys):
    assert tm.device_mesh(CPU, 4).devices == (CPU,) * 4
    assert capsys.readouterr().err == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.device_mesh(torch.device("cuda"), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = tm.device_mesh(torch.device("cuda"), 4)
    assert [d.index for d in mesh.devices] == [0, 1, 2, 0]
    assert capsys.readouterr().err == "--devices 4: 4 shards over 3 card(s)\n"
    assert [d.index for d in tm.device_mesh(torch.device("cuda"), 2).devices] == [0, 1]
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("with_lengths", [False, True])
def test_pad_batch_to_mesh(n, with_lengths):
    rng = np.random.default_rng(3)
    bases, quals, sizes = _strand(rng, 13, 2, 32)
    lengths = rng.integers(1, 33, 13).astype(np.int32) if with_lengths else None
    jmesh, tmesh = _meshes(n)
    ours = tm.pad_batch_to_mesh(bases, quals, sizes, tmesh, lengths)
    theirs = jm.pad_batch_to_mesh(bases, quals, sizes, jmesh, lengths)
    assert ours[4] == theirs[4] == 13
    assert (ours[3] is None) == (theirs[3] is None) == (not with_lengths)
    _same([x for x in ours[:4] if x is not None], [x for x in theirs[:4] if x is not None])


def test_stepstats_from_vector():
    for vec in (np.array([1, 2, 3, 4]), np.array([7, 0, 2**31 - 1, 5], np.int32)):
        assert dataclasses.astuple(tm.StepStats.from_vector(vec)) == \
            dataclasses.astuple(jm.StepStats.from_vector(vec))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", ["full", "lengths", "fewer_families"])
def test_sharded_consensus_batch_equals_jax(n, case):
    rng = np.random.default_rng(11 + n)
    cfg = JaxConfig()
    lengths = None
    if case == "fewer_families":  # 3 families padded to the mesh: empty shards
        bases, quals, sizes = _strand(rng, 3, 4, 32)
    elif case == "lengths":  # families padded to a wider length bucket
        true_len = 50
        b, q, sizes = _strand(rng, 16, 4, true_len)
        bases = np.full((16, 4, 64), PAD, np.uint8)
        quals = np.zeros((16, 4, 64), np.uint8)
        bases[:, :, :true_len], quals[:, :, :true_len] = b, q
        lengths = rng.integers(20, true_len + 1, 16).astype(np.int32)
    else:
        bases, quals, sizes = _strand(rng, 16, 4, 32, min_size=0)
    jmesh, tmesh = _meshes(n)
    pb, pq, ps, pl, n_real = jm.pad_batch_to_mesh(bases, quals, sizes, jmesh, lengths)
    theirs = jm.sharded_consensus_batch(pb, pq, ps, jmesh, cfg, lengths=pl)
    ours = tm.sharded_consensus_batch(pb, pq, ps, tmesh, consensus_vote.config_from_reference(cfg),
                                      lengths=pl)
    _same(ours[:2], theirs[:2])
    assert dataclasses.astuple(ours[2]) == dataclasses.astuple(theirs[2])
    assert ours[2].families == int((sizes > 0).sum())
    async_b, async_q = tm.sharded_vote_async(pb, pq, ps, tmesh)
    _same([async_b, async_q], theirs[:2])
    assert (_np(ours[0])[n_real:] == N).all()


def test_sharded_consensus_batch_refuses_an_unpadded_batch():
    rng = np.random.default_rng(1)
    bases, quals, sizes = _strand(rng, 13, 2, 16)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        tm.sharded_consensus_batch(bases, quals, sizes, tm.make_mesh(devices=[CPU] * 4))


@pytest.mark.parametrize("n", SIZES)
def test_member_shard_plan_and_stack_equal_jax(n):
    rng = np.random.default_rng(5 + n)
    for nf in (0, 3, 50, 257):
        sizes = rng.integers(0, 9, nf).astype(np.int32)
        ours, theirs = tm.plan_member_shards(sizes, n), jm.plan_member_shards(sizes, n)
        assert (ours.cuts, ours.nf_local, ours.m_local, ours.n_dev) == \
            (theirs.cuts, theirs.nf_local, theirs.m_local, theirs.n_dev)
        np.testing.assert_array_equal(ours.order(), theirs.order())
        m = int(sizes.sum())
        rows = rng.integers(0, 5, (m, 12)).astype(np.uint8)
        qrows = rng.integers(0, 41, (m, 12)).astype(np.uint8)
        _same(tm.stack_member_shards(ours, sizes, rows, qrows),
              jm.stack_member_shards(theirs, sizes, rows, qrows))
    assert tm.SHARD_MEMBER_QUANTUM == jm.SHARD_MEMBER_QUANTUM


def _stream_batch(rng, wire, nf):
    sizes = rng.integers(1, 9, nf).astype(np.int32)
    sizes[::7] = 0
    m = int(sizes.sum())
    base_hi = 4 if wire in ("pack4", "pack6") else 5
    bases = rng.integers(0, base_hi, (m, 64)).astype(np.uint8)
    quals = (BINNED[rng.integers(0, 4, (m, 64))] if wire == "pack4"
             else rng.integers(0, 41 if wire == "raw" else 16, (m, 64)).astype(np.uint8))
    a, b = tpack.encode_wire(wire, bases, quals)
    return a, b, sizes


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("wire", tpack.WIRES)
def test_stream_vote_sharded_equals_jax(n, wire):
    rng = np.random.default_rng(10 * tpack.WIRES.index(wire) + n)
    jcfg = JaxConfig(qual_threshold=10)
    num, den = jcfg.cutoff_rational
    jmesh, tmesh = _meshes(n)
    for nf, out_len in ((90, None), (5, 56)):  # a batch smaller than the mesh, cut planes
        a, b, sizes = _stream_batch(rng, wire, nf)
        theirs = jm.stream_vote_sharded(jmesh, wire, a, b, sizes, num, den,
                                        int(jcfg.qual_threshold), int(jcfg.qual_cap),
                                        None, out_len)
        ours = tm.stream_vote_sharded(tmesh, wire, a, b, sizes,
                                      consensus_vote.config_from_reference(jcfg), out_len)
        _same([ours], [theirs])
        order = tm.plan_member_shards(sizes, n).order()
        assert (_np(ours)[0, np.setdiff1d(np.arange(ours.shape[1]), order)] == N).all()


def test_duplex_batch_host_sharded_equals_jax():
    rng = np.random.default_rng(23)
    p, length = 37, 48  # an odd pair count: mesh padding
    s1, s2 = (rng.integers(0, 5, (p, length)).astype(np.uint8) for _ in range(2))
    q1, q2 = (rng.integers(0, 61, (p, length)).astype(np.uint8) for _ in range(2))
    want = jax_duplex_batch_host(s1, q1, s2, q2, 60)
    for n in SIZES:
        jmesh, tmesh = _meshes(n)
        ours = tm.duplex_batch_host_sharded(s1, q1, s2, q2, tmesh, 60)
        _same(ours, jm.duplex_batch_host_sharded(s1, q1, s2, q2, jmesh, 60))
        _same(ours, want)


@pytest.mark.parametrize("n", SIZES)
def test_full_pipeline_step_equals_jax(n):
    """``tests/test_mesh.py``'s step case: strand B missing on every fifth
    molecule."""
    rng = np.random.default_rng(23)
    ba, qa, na = _strand(rng, 24, 4, 48)
    bb, qb, nb = _strand(rng, 24, 4, 48)
    nb[::5] = 0
    for i in np.nonzero(nb == 0)[0]:
        bb[i], qb[i] = PAD, 0
    jmesh, tmesh = _meshes(n)
    theirs = jm.full_pipeline_step(jmesh, JaxConfig())(ba, qa, na, bb, qb, nb)
    ours = tm.full_pipeline_step(tmesh)(ba, qa, na, bb, qb, nb)
    _same(ours, theirs)
    assert int(ours[-1][0]) == 24 and int(ours[-1][1]) == int((nb > 0).sum())


@pytest.mark.parametrize("n", SIZES)
def test_packed_pipeline_step_equals_jax(n):
    """``tests/test_packing.py``'s pack8 step case: binned quals, PAD
    slots with a codebook qual."""
    rng = np.random.default_rng(5)
    ba, qa, na = _binned_strand(rng, 16, 4, 32)
    bb, qb, nb = _binned_strand(rng, 16, 4, 32)
    nb[::3] = 0
    book = jpack.build_codebook(np.concatenate([qa.ravel(), qb.ravel()]))
    np.testing.assert_array_equal(book, tpack.build_codebook(
        np.concatenate([qa.ravel(), qb.ravel()])))
    pa, pb = jpack.pack(ba, qa, book), jpack.pack(bb, qb, book)
    jmesh, tmesh = _meshes(n)
    theirs = jm.packed_pipeline_step(jmesh)(pa, na, pb, nb, book)
    ours = tm.packed_pipeline_step(tmesh)(pa, na, pb, nb, book)
    _same(ours, theirs)
    _same(ours, jm.full_pipeline_step(jmesh)(ba, qa, na, bb, qb, nb))


@pytest.mark.parametrize("n", SIZES)
def test_packed4_pipeline_step_equals_jax(n):
    """``tests/test_packing.py``'s pack4 step case (odd L: nibble padding)."""
    rng = np.random.default_rng(6)
    length = 33
    ba = rng.integers(0, 4, (16, 4, length)).astype(np.uint8)
    qa = BINNED[rng.integers(0, 4, (16, 4, length))]
    bb = rng.integers(0, 4, (16, 4, length)).astype(np.uint8)
    qb = BINNED[rng.integers(0, 4, (16, 4, length))]
    na = rng.integers(1, 5, 16).astype(np.int32)
    nb = rng.integers(0, 5, 16).astype(np.int32)
    book = jpack.build_codebook4(BINNED)
    pa, pb = jpack.pack4(ba, qa, book), jpack.pack4(bb, qb, book)
    jmesh, tmesh = _meshes(n)
    theirs = jm.packed4_pipeline_step(jmesh, length)(pa, na, pb, nb, book)
    ours = tm.packed4_pipeline_step(tmesh, length)(pa, na, pb, nb, book)
    _same(ours, theirs)
    _same(ours, jm.full_pipeline_step(jmesh)(ba, qa, na, bb, qb, nb))


# ------------------------------------------------------------ launch guard


class _FakeCuda:
    """Stands in for ``torch.cuda`` on a host without a card: tracks the
    current device through ``torch.cuda.device`` and names each stream by
    its device."""

    def __init__(self):
        self.current = 0
        self.asked = []

    def device(self, dev):
        fake = self

        class _Guard:
            def __enter__(self):
                self.prev, fake.current = fake.current, torch.device(dev).index

            def __exit__(self, *exc):
                fake.current = self.prev

        return _Guard()

    def current_stream(self, dev):
        self.asked.append(torch.device(dev).index)
        return type("Stream", (), {"cuda_stream": 1000 + torch.device(dev).index})()


class _FakeLib:
    def __init__(self, fake):
        self.fake = fake
        self.launched = []
        self.grids = []

    def cct_vote_tiles(self, *args):
        self.launched.append((self.fake.current, args[-1]))
        return 0

    def cct_tile_grid(self, *key):
        self.grids.append((self.fake.current, key))
        return 132


@pytest.mark.parametrize("duplex", [False, True])
def test_launch_runs_under_the_planes_card(monkeypatch, duplex):
    fake = _FakeCuda()
    lib = _FakeLib(fake)
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake.current_stream)
    monkeypatch.setattr(consensus_vote, "_library", lambda: lib)
    monkeypatch.setattr(consensus_vote, "_grids", {})
    card1 = torch.device("cuda", 1)
    # the grid of the planes' card, asked with that card current
    assert consensus_vote._grid(2, duplex, False, card1) == 132
    assert consensus_vote._grid(2, duplex, False, card1) == 132  # cached per card
    assert consensus_vote._grid(2, duplex, False, torch.device("cuda", 0)) == 132
    assert lib.grids == [(1, (2, int(duplex), 0)), (0, (2, int(duplex), 0))]
    # a prepared launch on planes of cuda:1, called while cuda:0 is current
    job = object.__new__(consensus_vote.TileLaunch)
    job.n_tiles, job.dev, job.duplex, job.with_qc = 4, card1, duplex, False
    job._args, job.out, job.stats = ("args",), "out", "stats"
    before = (consensus_vote.launches, consensus_vote.fused_launches)
    assert job() == ("out", "stats")
    assert lib.launched == [(1, 1001)] and fake.asked == [1] and fake.current == 0
    assert (consensus_vote.launches, consensus_vote.fused_launches) == \
        (before[0] + (not duplex), before[1] + duplex)
