"""The QC rider's plain version against the JAX package, on the CPU.

``consensus_vote.vote_wire(..., qc_lengths=...)`` on a CPU tensor runs the
plain version of the SSCS vote with the rider: per position, the sums over
the batch's families of the votes (members whose effective lane is one of
A, C, G, T, N) and of the votes that disagree with the modal lane, failed
votes included, at positions below each family's true length.  It is held
to the JAX package's ``_stream_vote_fn(..., with_qc=True)`` on member
streams made from a seed, on all four wires: cells past each family's
length (random content, as the wire's dead cells), size-0 families,
``qual_threshold`` 0 and 20, PAD members (on the wires that carry them), a
family over ``MAX_DENSE_CAP`` (the JAX segment path), and the length the
SSCS stage downloads (the longest family rounded up to 8) or the whole
width.  The outputs are integers: every comparison is exact.
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
CONFIGS = {"q0": JaxConfig(), "c05_q20": JaxConfig(cutoff=0.5, qual_threshold=20)}
LEVELS = {"raw": np.arange(42, dtype=np.uint8), "pack8": np.arange(5, 41, 3, dtype=np.uint8),
          "pack6": np.arange(8, 40, 2, dtype=np.uint8),
          "pack4": np.array([2, 12, 23, 37], np.uint8)}
CASES = ("ragged", "zero_runs", "family_600")


def _stream(wire, case, seed):
    """``(sizes, lengths, bases, quals)``: family sizes, each family's true
    length (below the row width, so every family has dead cells), and the
    member planes, dead rows at the end."""
    rng = np.random.default_rng(seed)
    width = 72
    if case == "ragged":
        sizes = rng.integers(0, 9, 250)
    elif case == "zero_runs":
        sizes = rng.integers(0, 3, 300)
        sizes[:15] = sizes[-15:] = sizes[90:130] = 0
    else:
        sizes = rng.integers(0, 5, 50)
        sizes[9] = 600
    sizes = sizes.astype(np.int32)
    lengths = rng.integers(width // 2, width - 3, sizes.shape[0]).astype(np.int32)
    lengths[rng.random(sizes.shape[0]) < 0.05] = 0
    m = int(sizes.sum()) + 6
    top = 4 if wire in ("pack4", "pack6") else 6  # PAD (5) on raw and pack8
    bases = rng.integers(0, top, (m, width), dtype=np.uint8)
    quals = rng.choice(LEVELS[wire], (m, width)).astype(np.uint8)
    # every third family mostly agrees, so passing votes and disagreement
    # both show up
    start = 0
    for f, size in enumerate(sizes):
        if f % 3 == 0 and size:
            keep = rng.random((size, width)) < 0.8
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


@pytest.mark.parametrize("trim", ["stage_out_len", "whole_width"])
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("wire", WIRES)
def test_rider_plain_matches_jax_stream_vote_with_qc(wire, case, config, trim):
    jcfg = CONFIGS[config]
    sizes, lengths, bases, quals = _stream(wire, case, WIRES.index(wire) * 7 + CASES.index(case))
    out_len = -(-int(lengths.max()) // 8) * 8 if trim == "stage_out_len" else None
    num, den = jcfg.cutoff_rational
    member_cap = jseg.pick_member_cap(sizes)
    assert (member_cap is None) == (case == "family_600")  # the JAX segment path
    fn = jseg._compiled_stream_vote(wire, num, den, int(jcfg.qual_threshold),
                                    int(jcfg.qual_cap), member_cap, out_len, True)
    want_planes, want_qc = fn(*_jax_wire(wire, bases, quals), sizes, lengths)
    a, b = tpack.encode_wire(wire, bases, quals)
    planes, qc = consensus_vote.vote_wire(
        wire, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(sizes),
        config_from_reference(jcfg), length=out_len, qc_lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(planes.numpy(), np.asarray(want_planes))
    assert qc.dtype == torch.int32
    np.testing.assert_array_equal(qc.numpy(), np.asarray(want_qc))
    # the inputs reach what the rider is for: votes, disagreement, and
    # positions that only dead cells fill
    assert int(qc[0].sum()) > 0 and int(qc[1].sum()) > 0
    # the stage's entry point is the same wrapper, and the rider leaves the
    # planes as they are without it
    via_stream = tseg.stream_vote(wire, torch.from_numpy(a), torch.from_numpy(b), sizes,
                                  config_from_reference(jcfg), out_len, lengths)
    assert torch.equal(via_stream[0], planes) and torch.equal(via_stream[1], qc)
    plain = consensus_vote.vote_wire(wire, torch.from_numpy(a), torch.from_numpy(b),
                                     torch.from_numpy(sizes), config_from_reference(jcfg),
                                     length=out_len)
    assert torch.equal(plain, planes)


@pytest.mark.parametrize("bad,match", [
    (np.zeros(3, np.int32), "one length per family"),
    (np.full(4, 9, np.int32), "outside"),
    (np.array([1, -1, 2, 0], np.int32), "outside"),
])
def test_rider_checks_the_lengths(bad, match):
    bases = np.zeros((6, 8), np.uint8)
    sizes = torch.tensor([1, 2, 3, 0])
    with pytest.raises(ValueError, match=match):
        consensus_vote.vote_wire("raw", torch.from_numpy(bases), torch.from_numpy(bases),
                                 sizes, qc_lengths=torch.from_numpy(bad))


def test_rider_counts_a_hand_made_family():
    """One family of five at one position: A A C, a low-qual member (votes
    N) and a PAD with a passing qual (no lane): 4 votes, top count 2,
    disagree 2, though the vote fails the cutoff; the second family's
    length masks its position 1."""
    bases = np.array([[0, 1], [0, 1], [1, 1], [2, 1], [5, 1], [3, 3], [3, 3]], np.uint8)
    quals = np.array([[30, 30], [30, 30], [30, 30], [5, 30], [30, 30], [30, 30],
                      [30, 30]], np.uint8)
    config = consensus_vote.ConsensusConfig(qual_threshold=10)
    planes, qc = consensus_vote.vote_wire(
        "raw", torch.from_numpy(bases), torch.from_numpy(quals), torch.tensor([5, 2]),
        config, qc_lengths=torch.tensor([2, 1]))
    assert planes[0, 0].tolist() == [4, 1]  # A fails 2/5 < 0.7; C passes 5/5
    assert qc.tolist() == [[4 + 2, 5], [2 + 0, 0]]


def test_stage_loop_hands_one_qc_total_to_the_sink():
    """The SSCS stage's batch loop adds every batch's rider sums into one
    int64 total and gives the sink that total alone, at the longest
    batch's length: no batch's buffers stay alive until the sink is
    finalized."""
    from consensuscruncher_tpu_torch.obs import qc as obs_qc
    from consensuscruncher_tpu_torch.parallel.batching import MemberBatch

    batches, want = [], np.zeros((2, 0), np.int64)
    for i, case in enumerate(CASES * 2):
        sizes, lengths, bases, quals = _stream("raw", case, 40 + i)
        n = sizes.shape[0]
        batch = MemberBatch(keys=list(range(n)), rows=bases, qrows=quals, sizes=sizes,
                            lengths=lengths, n_real=n, n_members=int(sizes.sum()))
        _planes, qc = tseg.stream_vote("raw", torch.from_numpy(bases), torch.from_numpy(quals),
                                       sizes, consensus_vote.ConsensusConfig(),
                                       tseg._out_len(batch), torch.from_numpy(lengths))
        width = max(want.shape[1], qc.shape[1])
        want = np.pad(want, ((0, 0), (0, width - want.shape[1])))
        want[:, :qc.shape[1]] += qc.numpy()
        batches.append(batch)
    acc = obs_qc.QcAccumulator()
    obs_qc.set_plane_sink(acc)
    try:
        out = list(tseg._run_member_batch_stream(batches, consensus_vote.ConsensusConfig(),
                                                 torch.device("cpu")))
    finally:
        obs_qc.set_plane_sink(None)
    assert len(out) == len(batches)
    (total,) = acc._handles
    assert total.dtype == torch.int64 and tuple(total.shape) == want.shape
    assert total.untyped_storage().nbytes() == total.numel() * 8  # its own buffer
    np.testing.assert_array_equal(total.numpy(), want)
    doc = acc.plane_doc()
    assert doc["positions"] == want.shape[1] and doc["votes"] == want[0].tolist()
