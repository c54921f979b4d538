"""The port's fused SSCS + DCS vote against the JAX package, byte for byte.

The port's dense fused form (``consensus_vote.duplex_batch``, on the CPU
its plain version, which the CUDA kernel is held to on the card) runs
against the TPU kernel ``duplex_batch_pallas_host`` in Pallas interpret
mode, on the cases of ``tests/test_pallas.py``.  The stream form
(``consensus_segment.segment_duplex_step``, ``run_duplex_pipelined``)
runs against the JAX package's XLA program of the same names.  The votes
are integer arithmetic with byte outputs: every comparison is exact.
"""

import os

import numpy as np
import pytest
import torch

from consensuscruncher_tpu.ops import consensus_segment as jseg
from consensuscruncher_tpu.ops.consensus_pallas import duplex_batch_pallas_host
from consensuscruncher_tpu.ops.consensus_tpu import ConsensusConfig as JaxConfig
from consensuscruncher_tpu.ops.packing import build_codebook4 as jax_codebook4
from consensuscruncher_tpu_torch.ops import consensus_segment as tseg
from consensuscruncher_tpu_torch.ops import consensus_vote, cuda_lib
from consensuscruncher_tpu_torch.ops.consensus_vote import config_from_reference
from consensuscruncher_tpu_torch.ops.duplex import duplex_vote
from consensuscruncher_tpu_torch.ops.packing import build_codebook4, pack4
from consensuscruncher_tpu_torch.utils.phred import N, PAD

PLANES = ("sscs_a_b", "sscs_a_q", "sscs_b_b", "sscs_b_q", "dcs_b", "dcs_q")
BINNED = np.array([2, 12, 23, 37], np.uint8)
CONFIGS = [JaxConfig(), JaxConfig(cutoff=0.5, qual_threshold=20),
           JaxConfig(cutoff=0.9, qual_threshold=30, qual_cap=45)]


def _batch(rng, batch, fam, length):
    """tests/test_pallas.py's strand batch: PAD past each family's size."""
    bases = rng.integers(0, 4, (batch, fam, length)).astype(np.uint8)
    quals = rng.integers(2, 41, (batch, fam, length)).astype(np.uint8)
    sizes = rng.integers(1, fam + 1, (batch,)).astype(np.int32)
    for i in range(batch):
        bases[i, sizes[i]:] = PAD
        quals[i, sizes[i]:] = 0
    return bases, quals, sizes


def _case(name):
    """The strand pair of one dense case: ``(ba, qa, sa, bb, qb, sb)``."""
    if name.startswith("random_"):
        batch, fam, length = (int(x) for x in name.split("_")[1:])
        rng = np.random.default_rng(batch + fam + length)
        return (*_batch(rng, batch, fam, length), *_batch(rng, batch, fam, length))
    if name == "singleton_families":  # F = 1: the vote copies, the combine works
        rng = np.random.default_rng(41)
        ba, bb = (rng.integers(0, 4, (8, 1, 32)).astype(np.uint8) for _ in range(2))
        qa, qb = (rng.integers(2, 41, (8, 1, 32)).astype(np.uint8) for _ in range(2))
        ones = np.ones(8, np.int32)
        return ba, qa, ones, bb, qb, ones.copy()
    if name.startswith("empty_"):  # size-0 all-PAD slots on one strand or both
        rng = np.random.default_rng(43)
        ba, qa, sa = _batch(rng, 8, 4, 32)
        bb, qb, sb = _batch(rng, 8, 4, 32)
        strands = {"a": [(ba, qa, sa)], "b": [(bb, qb, sb)],
                   "both": [(ba, qa, sa), (bb, qb, sb)]}[name.split("_")[1]]
        for bases, quals, sizes in strands:
            sizes[::2] = 0
            bases[::2] = PAD
            quals[::2] = 0
        return ba, qa, sa, bb, qb, sb
    if name.startswith("cutoff_"):  # 7 or 8 of 10 at cutoff 0.7
        winners = int(name.split("_")[1])
        ba = np.zeros((1, 10, 16), np.uint8)
        ba[0, winners:] = 2
        qa = np.full((1, 10, 16), 30, np.uint8)
        sizes = np.full(1, 10, np.int32)
        return ba, qa, sizes, ba.copy(), qa.copy(), sizes.copy()
    if name == "tie_demoted":  # a 1-1 tie, the third member demoted to N
        ba = np.array([[[2, 0], [3, 0], [1, 0], [PAD, PAD]]] * 8, np.uint8)
        qa = np.array([[[30, 30], [30, 30], [10, 30], [0, 0]]] * 8, np.uint8)
        bb = np.array([[[3, 0], [2, 0], [2, 0], [PAD, PAD]]] * 8, np.uint8)
        sizes = np.full(8, 3, np.int32)
        return ba, qa, sizes, bb, qa.copy(), sizes.copy()
    raise KeyError(name)


DENSE_CASES = ["random_8_4_32", "random_16_8_96", "random_3_2_64", "singleton_families",
               "empty_a", "empty_b", "empty_both", "cutoff_7", "cutoff_8", "tie_demoted"]


def _port_dense(case, jcfg):
    ba, qa, sa, bb, qb, sb = case
    t = torch.from_numpy
    return consensus_vote.duplex_batch(t(ba), t(qa), sa, t(bb), t(qb), sb,
                                       config_from_reference(jcfg))


@pytest.mark.parametrize("jcfg", CONFIGS)
@pytest.mark.parametrize("name", DENSE_CASES)
def test_dense_fused_matches_pallas_kernel(name, jcfg):
    case = _case(name)
    want = duplex_batch_pallas_host(*case, jcfg, interpret=True)
    got = _port_dense(case, jcfg)
    assert len(got) == 6
    for g, w, plane in zip(got, want, PLANES):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=plane)
    if name.startswith("empty_"):  # a missing strand leaves an all-N DCS
        assert (got[4][::2] == N).all() and (got[5][::2] == 0).all()
    if name == "cutoff_7" and jcfg == CONFIGS[0]:
        assert (got[4] == 0).all()


@pytest.mark.parametrize("name", ["empty_a", "empty_b", "empty_both", "random_8_4_32"])
def test_dense_dcs_needs_no_presence_mask(name):
    """The dense TPU kernel has no "both strands present" mask and the
    stream twin has one: they agree only because an empty strand votes N.
    The unmasked duplex combine of the two SSCS planes equals the masked
    one."""
    got = _port_dense(_case(name), JaxConfig())
    unmasked = duplex_vote(got[0], got[1], got[2], got[3])
    assert torch.equal(unmasked[0], got[4]) and torch.equal(unmasked[1], got[5])


def test_dense_sscs_planes_equal_the_sscs_vote():
    """Both kernels share one vote: the fused form's SSCS planes are the
    SSCS vote of each strand."""
    ba, qa, sa, bb, qb, sb = _case("random_16_8_96")
    got = _port_dense((ba, qa, sa, bb, qb, sb), JaxConfig())
    for (bases, quals, sizes), k in (((ba, qa, sa), 0), ((bb, qb, sb), 2)):
        vb, vq = consensus_vote.consensus_batch(torch.from_numpy(bases),
                                                torch.from_numpy(quals), sizes)
        assert torch.equal(got[k], vb) and torch.equal(got[k + 1], vq)


@pytest.mark.parametrize("case", ["fam", "length", "batch"])
def test_dense_strand_shape_mismatch_rejected(case):
    ba = np.zeros((4, 2, 32), np.uint8)
    bb = {"fam": np.zeros((4, 3, 32), np.uint8), "length": np.zeros((4, 2, 16), np.uint8),
          "batch": np.zeros((5, 2, 32), np.uint8)}[case]
    s = np.ones(4, np.int32)
    with pytest.raises(ValueError):
        duplex_batch_pallas_host(ba, ba, s, bb, np.zeros_like(bb), s)
    with pytest.raises(ValueError):
        consensus_vote.duplex_batch(torch.from_numpy(ba), torch.from_numpy(ba), s,
                                    torch.from_numpy(bb), torch.from_numpy(bb), s)


def test_dense_int32_cutoff_guard():
    """The cross-multiply guard the TPU wrapper applies to the family
    capacity: 1/1000 cutoff at F = 2,200,000 would overflow int32."""
    planes = torch.zeros((1, 2_200_000, 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="overflow"):
        consensus_vote.duplex_batch(planes, planes, [1], planes, planes, [1],
                                    consensus_vote.ConsensusConfig(cutoff=0.001))


# ------------------------------------------------------------- stream form


def _stream(seed, n_pairs, length, max_a=6, max_b=6, empty_b=False):
    rng = np.random.default_rng(seed)
    na = rng.integers(1, max_a, n_pairs).astype(np.int32)
    nb = rng.integers(0, max_b, n_pairs).astype(np.int32)
    if empty_b:
        nb[::3] = 0
    _f, _r, sizes = jseg.build_member_stream([na, nb])
    m = int(sizes.sum())
    bases = rng.integers(0, 4, (m, length)).astype(np.uint8)
    quals = BINNED[rng.integers(0, 4, (m, length))]
    return na, nb, sizes, bases, quals


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("cap", ["none", "pick"])
@pytest.mark.parametrize("shape", ["pairs16_L33", "pairs24_L21_empty_b"])
def test_segment_duplex_step_matches_jax(shape, cap, packed_out):
    n_pairs, length = (16, 33) if shape.startswith("pairs16") else (24, 21)
    na, nb, sizes, bases, quals = _stream(n_pairs * 7 + length, n_pairs, length,
                                          empty_b=shape.endswith("empty_b"))
    book = jax_codebook4(BINNED)
    member_cap = jseg.pick_member_cap(sizes) if cap == "pick" else None
    packed = pack4(bases, quals, build_codebook4(BINNED))
    want = jseg.segment_duplex_step(n_pairs, length, packed_out=packed_out,
                                    member_cap=member_cap)(
        jseg.pack4(bases, quals, book), sizes, book)
    got = tseg.segment_duplex_step(n_pairs, length, packed_out=packed_out,
                                   member_cap=member_cap)(
        torch.from_numpy(packed), torch.from_numpy(sizes), torch.from_numpy(book))
    assert len(got) == len(want) == (4 if packed_out else 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    stats = got[-1].numpy()
    assert stats[0] == n_pairs and stats[1] == int(((na > 0) & (nb > 0)).sum())


@pytest.mark.parametrize("config", [JaxConfig(cutoff=0.5, qual_threshold=10), JaxConfig()])
def test_segment_duplex_step_low_qual_tie_matches_jax(config):
    """One family with a demoted first member and a first-seen tie, its
    strand B absent (test_segment.py's dense-path edge case)."""
    sizes = np.array([4, 0], np.int32)
    bases = np.array([[2], [1], [1], [2]], np.uint8)
    quals = np.array([[2], [37], [37], [37]], np.uint8)
    book = jax_codebook4(BINNED)
    want = jseg.segment_duplex_step(1, 1, config, member_cap=4)(
        jseg.pack4(bases, quals, book), sizes, book)
    got = tseg.segment_duplex_step(1, 1, config_from_reference(config), member_cap=4)(
        torch.from_numpy(pack4(bases, quals, book)), sizes, torch.from_numpy(book))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_segment_stream_dcs_needs_no_presence_mask():
    """Stream form of the one-formula pin: the step's DCS (the JAX
    program vetoes pairs lacking a strand) equals the unmasked combine."""
    n_pairs, length = 24, 21
    _na, _nb, sizes, bases, quals = _stream(5, n_pairs, length, empty_b=True)
    book = build_codebook4(BINNED)
    out = tseg.segment_duplex_step(n_pairs, length)(
        torch.from_numpy(pack4(bases, quals, book)), sizes, torch.from_numpy(book))
    unmasked = duplex_vote(out[0], out[1], out[2], out[3])
    assert torch.equal(unmasked[0], out[4]) and torch.equal(unmasked[1], out[5])


def test_segment_step_member_cap_validates_never_routes():
    """The kernel takes any family size; a cap only refuses families
    larger than itself."""
    n_pairs, length = 4, 8
    _na, _nb, sizes, bases, quals = _stream(9, n_pairs, length, max_a=9)
    book = build_codebook4(BINNED)
    args = (torch.from_numpy(pack4(bases, quals, book)), sizes, torch.from_numpy(book))
    cap = int(sizes.max())
    no_cap = tseg.segment_duplex_step(n_pairs, length)(*args)
    with_cap = tseg.segment_duplex_step(n_pairs, length, member_cap=cap)(*args)
    assert all(torch.equal(a, b) for a, b in zip(no_cap, with_cap))
    with pytest.raises(ValueError, match="member_cap"):
        tseg.segment_duplex_step(n_pairs, length, member_cap=cap - 1)(*args)
    with pytest.raises(ValueError, match="family sizes"):
        tseg.segment_duplex_step(n_pairs + 1, length)(*args)


@pytest.mark.parametrize("chunk_pairs,member_bucket,member_cap",
                         [(16, 32, "auto"), (8, 64, None), (64, 4096, "auto")])
def test_run_duplex_pipelined_matches_jax(chunk_pairs, member_bucket, member_cap):
    """Chunked and member-padded (test_segment.py's shapes): the port's
    pipelined runner equals the JAX one and the single-shot step."""
    n_pairs, length = 50, 17
    na, nb, sizes, bases, quals = _stream(13, n_pairs, length)
    book = jax_codebook4(BINNED)
    want = jseg.run_duplex_pipelined(bases, quals, na, nb, book, chunk_pairs=chunk_pairs,
                                     member_bucket=member_bucket, member_cap=member_cap)
    got = tseg.run_duplex_pipelined(bases, quals, na, nb, book, chunk_pairs=chunk_pairs,
                                    member_bucket=member_bucket, member_cap=member_cap,
                                    device="cpu")
    single = tseg.segment_duplex_step(n_pairs, length)(
        torch.from_numpy(pack4(bases, quals, book)), sizes, torch.from_numpy(book))
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, s.numpy())


def test_run_duplex_pipelined_rejects_undersized_cap():
    na, nb = np.array([9], np.int32), np.array([0], np.int32)
    bases = np.zeros((9, 4), np.uint8)
    quals = np.full((9, 4), 37, np.uint8)
    with pytest.raises(ValueError, match="member_cap=4 < max family size 9"):
        tseg.run_duplex_pipelined(bases, quals, na, nb, build_codebook4(BINNED),
                                  member_cap=4, device="cpu")


def test_derive_host_outputs_matches_jax():
    rng = np.random.default_rng(17)
    n, length = 40, 24
    packed = (rng.integers(0, 5, (n, length)) | rng.integers(0, 5, (n, length)) << 3
              ).astype(np.uint8)
    qa, qb = (rng.integers(0, 61, (n, length)).astype(np.uint8) for _ in range(2))
    sa, sb = (rng.integers(0, 3, n).astype(np.int32) for _ in range(2))
    for cfg in CONFIGS:
        want = jseg.derive_host_outputs(packed, qa, qb, sa, sb, cfg)
        got = tseg.derive_host_outputs(packed, qa, qb, sa, sb, config_from_reference(cfg))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arrays", [[[2, 1], [0, 3]], [[0, 0], [5]], [[1] * 7, [2] * 7]])
def test_build_member_stream_and_pick_member_cap_match_jax(arrays):
    arrays = [np.array(a, np.int32) for a in arrays]
    for g, w in zip(tseg.build_member_stream(arrays), jseg.build_member_stream(arrays)):
        np.testing.assert_array_equal(g, w)
    sizes = np.concatenate(arrays)
    for probe in (sizes, sizes * 100, np.array([tseg.MAX_DENSE_CAP + 1])):
        assert tseg.pick_member_cap(probe) == jseg.pick_member_cap(probe)
    assert tseg.MAX_DENSE_CAP == jseg.MAX_DENSE_CAP


# ---------------------------------------------------------------- the build


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited header changes the library's hash, so a stale build is
    never loaded; the committed kernel source includes its vote header."""
    assert [os.path.basename(p) for p in cuda_lib.build_inputs("consensus_vote")] == [
        "consensus_vote.cu", "vote_state.cuh"]
    (tmp_path / "k.cu").write_text('#include "inc/h.cuh"\nint k;\n')
    (tmp_path / "inc").mkdir()
    (tmp_path / "inc" / "h.cuh").write_text('#include "g.cuh"\n')
    (tmp_path / "inc" / "g.cuh").write_text("int g;\n")
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", str(tmp_path))
    first = cuda_lib.library_path("k")
    (tmp_path / "inc" / "g.cuh").write_text("int g2;\n")
    assert cuda_lib.library_path("k") != first
