"""The wire-taking vote wrappers against the JAX package, on the CPU.

``consensus_vote.vote_wire`` and ``duplex_wire`` take a member stream on one
of the four wires (raw, pack8, pack6, pack4) and, on the card, decode it
inside the vote kernel.  On the CPU they run their plain versions
(``unpack_wire`` + the plain votes + the duplex stats); here they are held
to the JAX package's ``_compiled_stream_vote`` and ``segment_duplex_step``
on member batches made from a seed.  A plain Python model of the kernel's
decode (per position, and kPos positions at a time from little-endian words
as ``load_group`` reads them) is held to ``unpack_wire`` and to the JAX
``unpack*_device``.  The outputs are integers: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from consensuscruncher_tpu.ops import consensus_segment as jseg
from consensuscruncher_tpu.ops import packing as jpack
from consensuscruncher_tpu.ops.consensus_tpu import ConsensusConfig as JaxConfig
from consensuscruncher_tpu_torch.ops import consensus_segment as tseg
from consensuscruncher_tpu_torch.ops import consensus_vote
from consensuscruncher_tpu_torch.ops import packing as tpack
from consensuscruncher_tpu_torch.ops.consensus_vote import config_from_reference

WIRES = tpack.WIRES
CONFIGS = [JaxConfig(), JaxConfig(cutoff=0.5, qual_threshold=20)]
BINNED = np.array([2, 12, 23, 37], np.uint8)
# quals each wire's codebook holds (raw: any byte a read carries)
LEVELS = {"raw": np.arange(42, dtype=np.uint8), "pack8": np.arange(5, 41, 3, dtype=np.uint8),
          "pack6": np.arange(8, 40, 2, dtype=np.uint8), "pack4": BINNED}


def _sizes(rng, case):
    if case == "random":
        return rng.integers(0, 9, 300).astype(np.int32)
    if case == "zero_runs":  # empty slots at both ends and in runs, singletons
        sizes = rng.integers(0, 3, 400).astype(np.int32)
        sizes[:20] = 0
        sizes[-20:] = 0
        sizes[100:140] = 0
        return sizes
    if case == "family_600":  # past the JAX gather cap: its segment path
        sizes = rng.integers(0, 5, 60).astype(np.int32)
        sizes[7] = 600
        return sizes
    raise KeyError(case)


def _planes(rng, wire, m, length):
    """``(m, length)`` bases and quals a ``wire`` can carry: ACGT for the
    2-bit wires, A C G T N PAD for raw and pack8."""
    top = 4 if wire in ("pack4", "pack6") else 6
    bases = rng.integers(0, top, (m, length), dtype=np.uint8)
    quals = rng.choice(LEVELS[wire], (m, length)).astype(np.uint8)
    return bases, quals


def _jax_wire(wire, bases, quals):
    """The JAX package's own encode of the same planes."""
    if wire == "raw":
        return bases, quals
    if wire == "pack4":
        book = jpack.build_codebook4(quals)
        return jpack.pack4(bases, quals, book), book
    book = jpack.build_codebook(quals)
    return (jpack.pack if wire == "pack8" else jpack.pack6)(bases, quals, book), book


@pytest.mark.parametrize("jcfg", CONFIGS, ids=["default", "c05_q20"])
@pytest.mark.parametrize("case,length,out_len", [("random", 96, 90), ("zero_runs", 100, None),
                                                 ("family_600", 64, 61)])
@pytest.mark.parametrize("wire", WIRES)
def test_vote_wire_matches_jax_stream_vote(wire, case, length, out_len, jcfg):
    rng = np.random.default_rng(WIRES.index(wire) * 10 + len(case) + length)
    sizes = _sizes(rng, case)
    bases, quals = _planes(rng, wire, int(sizes.sum()) + 5, length)  # + dead rows
    a, b = tpack.encode_wire(wire, bases, quals)
    num, den = jcfg.cutoff_rational
    want = jseg._compiled_stream_vote(wire, num, den, int(jcfg.qual_threshold),
                                      int(jcfg.qual_cap), jseg.pick_member_cap(sizes),
                                      out_len)(*_jax_wire(wire, bases, quals), sizes)
    got = consensus_vote.vote_wire(wire, torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(sizes), config_from_reference(jcfg),
                                   length=out_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the stream API the SSCS stage calls is the same wrapper
    via_stream = tseg.stream_vote(wire, torch.from_numpy(a), torch.from_numpy(b), sizes,
                                  config_from_reference(jcfg), out_len)
    assert torch.equal(via_stream, got)


def _duplex_stream(seed, n_pairs, length, big=False):
    rng = np.random.default_rng(seed)
    na = rng.integers(0, 7, n_pairs).astype(np.int32)
    nb = rng.integers(0, 7, n_pairs).astype(np.int32)
    nb[::5] = 0
    if big:
        na[3] = 300
    sizes = np.concatenate([na, nb])
    m = int(sizes.sum())
    bases = rng.integers(0, 4, (m + 3, length)).astype(np.uint8)
    quals = BINNED[rng.integers(0, 4, (m + 3, length))]
    return sizes, bases, quals


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("shape", ["pairs40_L33", "pairs25_L64_big"])
@pytest.mark.parametrize("wire", ["pack4", "raw"])
def test_duplex_wire_matches_jax_segment_step(wire, shape, packed_out):
    """The duplex wrapper (planes, stats, ``packed_out``) against the JAX
    fused step on the same stream; the JAX step always takes pack4, the
    port's wrapper takes the named wire."""
    n_pairs, length = (40, 33) if shape.startswith("pairs40") else (25, 64)
    sizes, bases, quals = _duplex_stream(n_pairs + length, n_pairs, length,
                                         big=shape.endswith("big"))
    config = JaxConfig(cutoff=0.5, qual_threshold=10)
    book = jpack.build_codebook4(BINNED)
    want = jseg.segment_duplex_step(n_pairs, length, config, packed_out=packed_out)(
        jpack.pack4(bases, quals, book), sizes, book)
    a, b = tpack.encode_wire(wire, bases, quals)
    planes, stats = consensus_vote.duplex_wire(wire, torch.from_numpy(a), torch.from_numpy(b),
                                               torch.from_numpy(sizes),
                                               config_from_reference(config), length,
                                               packed_out=packed_out)
    assert planes.shape[0] == (3 if packed_out else 6)
    for g, w in zip(list(planes) + [stats], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_duplex_wire_stats_count_the_pairs():
    sizes = np.array([2, 0, 1, 3, 0, 0], np.int32)  # pairs (2,3) (0,0) (1,0)
    bases = np.zeros((6, 8), np.uint8)
    quals = np.full((6, 8), 30, np.uint8)
    _planes_, stats = consensus_vote.duplex_wire("raw", torch.from_numpy(bases),
                                                 torch.from_numpy(quals), sizes)
    # real pairs 2, duplexes 1; the duplex agrees on A at 8 positions, qual
    # min(60 + 60, 60) = 60
    assert stats.tolist() == [2, 1, 0, 8 * 60]


# ------------------------------------------------------ the kernel's decode


def _model_position(wire, row, p, book):
    """The kernel's per-position decode formulas (csrc/consensus_vote.cu)."""
    w8 = [int(x) for x in row]
    if wire == "pack8":
        return w8[p] & 7, int(book[w8[p] >> 3])
    if wire == "pack6":
        w = len(w8) // 3
        return (w8[p // 4] >> (2 * (p % 4))) & 3, int(book[(w8[w + p // 2] >> (4 * (p % 2))) & 15])
    n = (w8[p // 2] >> (4 * (p % 2))) & 15  # pack4
    return n & 3, int(book[n >> 2])


def _le(row, i, nbytes):
    """``nbytes`` bytes of ``row`` at ``i``, little-endian; past the row, 0."""
    return sum(int(row[i + j]) << (8 * j) for j in range(nbytes) if i + j < len(row))


def _model_group(wire, row, g, kpos, book):
    """Positions ``kpos*g ..`` of one row as the kernel's ``load_group``
    reads them: whole little-endian words, then shifts."""
    p0 = kpos * g
    nib_bytes = max(1, kpos // 2)
    out = []
    if wire == "pack8":
        x = _le(row, p0, kpos)
        for j in range(kpos):
            w = (x >> (8 * j)) & 0xFF
            out.append((w & 7, int(book[w >> 3])))
    elif wire == "pack6":
        wq = len(row) // 3
        bb = int(row[p0 // 4]) >> (2 * (p0 % 4))
        qq = _le(row, wq + p0 // 2, nib_bytes) >> (4 * (p0 % 2))
        for j in range(kpos):
            out.append(((bb >> (2 * j)) & 3, int(book[(qq >> (4 * j)) & 15])))
    else:  # pack4
        nn = _le(row, p0 // 2, nib_bytes) >> (4 * (p0 % 2))
        for j in range(kpos):
            n = (nn >> (4 * j)) & 15
            out.append((n & 3, int(book[n >> 2])))
    return out


def _jax_unpack(wire, a, book, length):
    if wire == "pack8":
        return jpack.unpack_device(a, book)
    if wire == "pack6":
        return jpack.unpack6_device(a, book, length)
    return jpack.unpack4_device(a, book, length)


@pytest.mark.parametrize("length", [32, 64, 100])
@pytest.mark.parametrize("wire", ["pack8", "pack6", "pack4"])
def test_kernel_decode_model_matches_unpacks(wire, length):
    rng = np.random.default_rng(length + WIRES.index(wire))
    bases, quals = _planes(rng, wire, 12, length)
    a, book = tpack.encode_wire(wire, bases, quals)
    width = tpack.wire_width(wire, a)
    t_b, t_q = (x.numpy() for x in tpack.unpack_wire(wire, torch.from_numpy(a),
                                                      torch.from_numpy(book)))
    j_b, j_q = (np.asarray(x) for x in _jax_unpack(wire, a, book, width))
    np.testing.assert_array_equal(t_b, j_b)
    np.testing.assert_array_equal(t_q, j_q)
    np.testing.assert_array_equal(t_b[:, :length], bases)
    np.testing.assert_array_equal(t_q[:, :length], quals)
    for r, row in enumerate(a):
        per_position = [_model_position(wire, row, p, book) for p in range(width)]
        assert per_position == list(zip(t_b[r].tolist(), t_q[r].tolist()))
        for kpos in (1, 2, 4):
            grouped = [bq for g in range(-(-width // kpos))
                       for bq in _model_group(wire, row, g, kpos, book)]
            assert grouped[:width] == per_position, (r, kpos)
