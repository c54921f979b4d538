"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a card.  Imports no JAX, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from consensuscruncher_tpu_torch.cli import main as cli_main
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.ops import consensus_segment, consensus_vote
from consensuscruncher_tpu_torch.ops.packing import WIRES, build_codebook4, encode_wire, pack4
from consensuscruncher_tpu_torch.utils.phred import PAD

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("cutoff,qual_threshold", [(0.7, 0), (0.5, 20), (0.9, 30)])
def test_stream_kernel_matches_plain(card, cutoff, qual_threshold):
    rng = np.random.default_rng(int(cutoff * 10) + qual_threshold)
    sizes = rng.integers(0, 9, 3000).astype(np.int32)
    sizes[:2] = [1200, 1]
    m, length = int(sizes.sum()), 100
    bases = torch.from_numpy(rng.integers(0, 6, (m, length), dtype=np.uint8)).to(card)
    quals = torch.from_numpy(rng.integers(0, 42, (m, length), dtype=np.uint8)).to(card)
    cfg = consensus_vote.ConsensusConfig(cutoff=cutoff, qual_threshold=qual_threshold)
    before = consensus_vote.launches
    got = consensus_vote.vote_members(bases, quals, torch.from_numpy(sizes), cfg, length=97)
    assert consensus_vote.launches == before + 1
    want = consensus_vote.vote_members_plain(bases, quals, torch.from_numpy(sizes), cfg,
                                             length=97)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_dense_kernel_matches_plain(card):
    rng = np.random.default_rng(3)
    b, f, length = 256, 8, 64
    bases = rng.integers(0, 5, (b, f, length)).astype(np.uint8)
    quals = rng.integers(2, 41, (b, f, length)).astype(np.uint8)
    sizes = rng.integers(0, f + 1, b).astype(np.int32)
    for i in range(b):
        bases[i, sizes[i]:] = PAD
    got_b, got_q = consensus_vote.consensus_batch(
        torch.from_numpy(bases).to(card), torch.from_numpy(quals).to(card), sizes)
    want_b, want_q = consensus_vote.consensus_batch(
        torch.from_numpy(bases), torch.from_numpy(quals), sizes)
    assert torch.equal(got_b.cpu(), want_b) and torch.equal(got_q.cpu(), want_q)


def test_stream_vote_on_card_matches_cpu(card):
    rng = np.random.default_rng(4)
    sizes = np.full(64, 3, np.int32)
    rows = rng.integers(0, 4, (192, 64), dtype=np.uint8)
    qrows = rng.choice(np.array([10, 20, 30, 40], np.uint8), (192, 64))
    book = build_codebook4(qrows)
    packed = pack4(rows, qrows, book)
    args = (torch.from_numpy(packed), torch.from_numpy(book))
    on_card = consensus_segment.stream_vote("pack4", *(t.to(card) for t in args), sizes,
                                            out_len=60)
    on_cpu = consensus_segment.stream_vote("pack4", *args, sizes, out_len=60)
    assert torch.equal(on_card.cpu(), on_cpu)


def _strand(rng, b, f, length, empty_every=0):
    bases = rng.integers(0, 5, (b, f, length)).astype(np.uint8)
    quals = rng.integers(2, 41, (b, f, length)).astype(np.uint8)
    sizes = rng.integers(1, f + 1, b).astype(np.int32)
    if empty_every:
        sizes[::empty_every] = 0
    for i in range(b):
        bases[i, sizes[i]:] = PAD
        quals[i, sizes[i]:] = 0
    return bases, quals, sizes


@pytest.mark.parametrize("cutoff,qual_threshold", [(0.7, 0), (0.5, 20), (0.9, 30)])
def test_fused_dense_kernel_matches_plain(card, cutoff, qual_threshold):
    rng = np.random.default_rng(int(cutoff * 10) + qual_threshold + 100)
    ba, qa, sa = _strand(rng, 300, 8, 100, empty_every=5)
    bb, qb, sb = _strand(rng, 300, 8, 100, empty_every=7)
    cfg = consensus_vote.ConsensusConfig(cutoff=cutoff, qual_threshold=qual_threshold)
    t = torch.from_numpy
    before = consensus_vote.fused_launches
    got = consensus_vote.duplex_batch(t(ba).to(card), t(qa).to(card), sa,
                                      t(bb).to(card), t(qb).to(card), sb, cfg)
    assert consensus_vote.fused_launches == before + 1
    want = consensus_vote.duplex_batch(t(ba), t(qa), sa, t(bb), t(qb), sb, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("packed_out", [False, True])
def test_segment_duplex_step_on_card_matches_cpu(card, packed_out):
    rng = np.random.default_rng(5)
    n_pairs, length = 700, 101
    sizes = np.concatenate([rng.integers(1, 9, n_pairs), rng.integers(0, 9, n_pairs)])
    sizes = sizes.astype(np.int32)
    sizes[0] = 1500  # a deep family: no member cap
    m = int(sizes.sum())
    book = build_codebook4(np.array([2, 12, 23, 37], np.uint8))
    packed = pack4(rng.integers(0, 4, (m + 64, length), dtype=np.uint8),
                   book[rng.integers(0, 4, (m + 64, length))], book)
    step = consensus_segment.segment_duplex_step(n_pairs, length, packed_out=packed_out)
    args = (torch.from_numpy(packed), torch.from_numpy(sizes), torch.from_numpy(book))
    on_card = step(*(t.to(card) for t in args))
    on_cpu = step(*args)
    for g, w in zip(on_card, on_cpu):
        assert torch.equal(g.cpu(), w)


def test_run_duplex_pipelined_on_card_matches_cpu(card):
    rng = np.random.default_rng(6)
    n_pairs, length = 3000, 64
    sa = rng.integers(1, 6, n_pairs).astype(np.int32)
    sb = rng.integers(0, 6, n_pairs).astype(np.int32)
    m = int(sa.sum() + sb.sum())
    book = build_codebook4(np.array([2, 12, 23, 37], np.uint8))
    rows = rng.integers(0, 4, (m, length), dtype=np.uint8)
    qrows = book[rng.integers(0, 4, (m, length))]
    before = consensus_vote.fused_launches
    on_card = consensus_segment.run_duplex_pipelined(
        rows, qrows, sa, sb, book, chunk_pairs=1024, member_bucket=4096, device=card)
    assert consensus_vote.fused_launches == before + 3  # one launch per chunk
    on_cpu = consensus_segment.run_duplex_pipelined(
        rows, qrows, sa, sb, book, chunk_pairs=1024, member_bucket=4096, device="cpu")
    for g, w in zip(on_card, on_cpu):
        np.testing.assert_array_equal(g, w)


def test_resident_store_on_card_matches_cpu(card):
    from consensuscruncher_tpu_torch.ops.packing import resident_planes

    rng = np.random.default_rng(8)
    planes = np.stack([rng.integers(0, 5, (50, 40), dtype=np.uint8),
                       rng.integers(0, 61, (50, 40), dtype=np.uint8)])
    keys = [f"k{i}".encode() for i in range(50)]
    stores = [resident_planes(dev) for dev in (card, torch.device("cpu"))]
    for store in stores:
        store.append(keys, [33] * 50, torch.from_numpy(planes).to(store.device), 50)
    idx1, idx2 = stores[1].rows_for(keys[:20], 33), stores[1].rows_for(keys[20:40], 33)
    s1 = rng.integers(0, 4, (20, 33), dtype=np.uint8)
    q1 = rng.integers(0, 41, (20, 33), dtype=np.uint8)
    got = [np.concatenate(s.duplex_pairs(idx1, idx2, 33) + s.duplex_against(s1, q1, idx2, 33))
           for s in stores]
    np.testing.assert_array_equal(got[0], got[1])


# ------------------------------------------------------- the wire kernels


def _wire_stream(rng, wire, sizes, length, pad_rows=9):
    """A member stream on ``wire`` for ``sizes``: ACGT (plus N and PAD on
    raw and pack8), quals from a codebook the wire holds."""
    m = int(sizes.sum()) + pad_rows
    top = 4 if wire in ("pack4", "pack6") else 6
    bases = rng.integers(0, top, (m, length), dtype=np.uint8)
    levels = {"raw": np.arange(42, dtype=np.uint8), "pack8": np.arange(5, 41, 3, dtype=np.uint8),
              "pack6": np.arange(8, 40, 2, dtype=np.uint8),
              "pack4": np.array([2, 12, 23, 37], np.uint8)}[wire]
    quals = rng.choice(levels, (m, length)).astype(np.uint8)
    a, b = encode_wire(wire, bases, quals)
    return torch.from_numpy(np.ascontiguousarray(a)), torch.from_numpy(b)


def _book_or_quals(wire, b, card):
    """The raw wire's quals plane goes to the card; a codebook stays on the
    host (the kernel takes it by value)."""
    return b.to(card) if wire == "raw" else b


def _edge_sizes(rng, case):
    if case == "random":
        return rng.integers(0, 9, 3000).astype(np.int64)
    if case == "zeros_at_tile_edges":  # empty slots at starts and ends of tiles
        sizes = rng.integers(0, 4, 5000).astype(np.int64)
        sizes[::37] = 0
        sizes[:50] = 0
        sizes[-50:] = 0
        return sizes
    if case == "straddling":  # families near the stage's byte budget
        sizes = rng.integers(1, 6, 2000).astype(np.int64)
        sizes[[10, 500, 1500]] = [200, 250, 256]
        return sizes
    if case == "family_1500":  # the direct path: more than a stage holds
        sizes = rng.integers(0, 5, 400).astype(np.int64)
        sizes[[0, 200]] = [1500, 257]
        return sizes
    if case == "families_70000":
        return rng.integers(0, 4, 70000).astype(np.int64)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["random", "zeros_at_tile_edges", "straddling",
                                  "family_1500", "families_70000"])
@pytest.mark.parametrize("wire", WIRES)
def test_wire_kernel_matches_plain(card, wire, case):
    rng = np.random.default_rng(len(case) * 10 + WIRES.index(wire))
    sizes = _edge_sizes(rng, case)
    length = 40 if case == "families_70000" else 128
    a, b = _wire_stream(rng, wire, sizes, length)
    a_d = a.to(card)
    for cfg in (consensus_vote.ConsensusConfig(),
                consensus_vote.ConsensusConfig(cutoff=0.5, qual_threshold=20)):
        for out_len in (length, length - 5):
            before = consensus_vote.launches
            got = consensus_vote.vote_wire(wire, a_d, _book_or_quals(wire, b, card),
                                           torch.from_numpy(sizes), cfg, out_len)
            assert consensus_vote.launches == before + 1
            # the plain version on the card (torch decode, plain vote)
            want = consensus_vote.vote_wire_plain(wire, a_d, b.to(card),
                                                  torch.from_numpy(sizes), cfg, out_len)
            assert torch.equal(got, want), (wire, case, cfg, out_len)
    if case == "family_1500":
        assert consensus_vote.last_plan.summary()["direct"] >= 2


@pytest.mark.parametrize("wire", ["raw", "pack8"])
def test_wire_kernel_unaligned_rows(card, wire):
    """L 100 and L 33: rows that are not a multiple of 16 (or 4) bytes."""
    rng = np.random.default_rng(33)
    for length in (100, 33):
        sizes = rng.integers(0, 7, 1000).astype(np.int64)
        a, b = _wire_stream(rng, wire, sizes, length)
        got = consensus_vote.vote_wire(wire, a.to(card), _book_or_quals(wire, b, card), sizes)
        want = consensus_vote.vote_wire(wire, a, b, sizes)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("wire", WIRES)
def test_duplex_wire_matches_plain(card, wire, packed_out):
    """Stats and packed_out planes of the fused kernel equal the CPU's, one
    launch per call, with empty strands and a 1,500-member family."""
    rng = np.random.default_rng(WIRES.index(wire) + 50)
    n_pairs, length = 3000, 128
    sizes = np.concatenate([rng.integers(0, 8, n_pairs), rng.integers(0, 8, n_pairs)])
    sizes[[0, n_pairs + 7]] = [1500, 300]
    a, b = _wire_stream(rng, wire, sizes, length)
    cfg = consensus_vote.ConsensusConfig(cutoff=0.5, qual_threshold=10)
    before = consensus_vote.fused_launches
    got, got_stats = consensus_vote.duplex_wire(wire, a.to(card), _book_or_quals(wire, b, card),
                                                sizes, cfg, length - 3,
                                                packed_out=packed_out)
    assert consensus_vote.fused_launches == before + 1
    want, want_stats = consensus_vote.duplex_wire(wire, a, b, sizes, cfg, length - 3,
                                                  packed_out=packed_out)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got_stats.cpu(), want_stats)


def test_segment_duplex_step_is_one_launch(card):
    rng = np.random.default_rng(9)
    n_pairs, length = 1000, 128
    sizes = rng.integers(0, 8, 2 * n_pairs).astype(np.int32)
    a, book = _wire_stream(rng, "pack4", sizes, length)
    step = consensus_segment.segment_duplex_step(n_pairs, length, packed_out=True)
    packed = a.to(card)
    torch.cuda.synchronize()
    before = (consensus_vote.fused_launches, consensus_vote.launches)
    out = step(packed, sizes, book)
    assert (consensus_vote.fused_launches, consensus_vote.launches) == (before[0] + 1,
                                                                         before[1])
    want = step(a, sizes, book)
    for g, w in zip(out, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("case", ["random", "zeros_at_tile_edges", "family_1500",
                                  "families_70000", "long_rows"])
@pytest.mark.parametrize("wire", WIRES)
def test_qc_rider_matches_plain(card, wire, case):
    """The QC rider inside the SSCS kernel against the plain version on the
    card, exactly: per-family true lengths that differ inside the batch,
    size-0 families, qualscore 0 and 20, PAD cells on the wires that carry
    them, the direct path, and rows longer than the rider's shared-memory
    sums hold (its global-atomic form)."""
    rng = np.random.default_rng(len(case) * 10 + WIRES.index(wire) + 100)
    if case == "long_rows":
        sizes, length = rng.integers(0, 6, 800).astype(np.int64), 640
    else:
        sizes = _edge_sizes(rng, case)
        length = 40 if case == "families_70000" else 128
    a, b = _wire_stream(rng, wire, sizes, length)
    a_d = a.to(card)
    lengths = rng.integers(0, length + 1, sizes.shape[0]).astype(np.int32)
    for cfg in (consensus_vote.ConsensusConfig(),
                consensus_vote.ConsensusConfig(cutoff=0.5, qual_threshold=20)):
        for out_len in (length, length - 5):
            live = torch.from_numpy(np.minimum(lengths, out_len))
            before = (consensus_vote.launches, consensus_vote.qc_launches)
            got, got_qc = consensus_vote.vote_wire(wire, a_d, _book_or_quals(wire, b, card),
                                                   torch.from_numpy(sizes), cfg, out_len,
                                                   qc_lengths=live)
            assert (consensus_vote.launches, consensus_vote.qc_launches) == (
                before[0] + 1, before[1] + 1)
            want, want_qc = consensus_vote.vote_wire_plain(
                wire, a_d, b.to(card), torch.from_numpy(sizes), cfg, out_len, qc_lengths=live)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (wire, case, cfg, out_len)
            assert torch.equal(got_qc, want_qc), (wire, case, cfg, out_len)
            assert int(got_qc[0].sum()) > 0


def test_qc_rider_stage_loop_keeps_device_memory_flat(card):
    """The SSCS stage's batch loop with a QC sink armed: device memory after
    many batches is that after one, plus nothing but the one (2, L) int64
    total the sink holds; the total equals the CPU loop's."""
    from consensuscruncher_tpu_torch.obs import qc as obs_qc
    from consensuscruncher_tpu_torch.parallel.batching import MemberBatch

    rng = np.random.default_rng(11)
    length, batches = 104, []
    for _ in range(48):
        sizes = rng.integers(1, 5, 4000).astype(np.int32)
        m = int(sizes.sum())
        batches.append(MemberBatch(
            keys=list(range(sizes.shape[0])),
            rows=rng.integers(0, 4, (m, length), dtype=np.uint8),
            qrows=rng.choice(np.array([2, 12, 23, 37], np.uint8), (m, length)),
            sizes=sizes, lengths=rng.integers(60, length + 1, sizes.shape[0]).astype(np.int32),
            n_real=sizes.shape[0], n_members=m))
    cfg = consensus_vote.ConsensusConfig()
    totals, grew = {}, {}
    for dev in (torch.device("cpu"), card):
        acc = obs_qc.QcAccumulator()
        obs_qc.set_plane_sink(acc)
        try:
            loop = consensus_segment._run_member_batch_stream(batches, cfg, dev)
            next(loop)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                after_one = torch.cuda.memory_allocated(card)
            for _ in loop:
                pass
            if dev.type == "cuda":
                torch.cuda.synchronize()
                grew["cuda"] = torch.cuda.memory_allocated(card) - after_one
        finally:
            obs_qc.set_plane_sink(None)
        (totals[dev.type],) = acc._handles
    assert grew["cuda"] <= 4096, grew  # not ~0.4 MB per batch
    assert torch.equal(totals["cuda"].cpu(), totals["cpu"])


@pytest.mark.parametrize("qual_threshold", [0, 30])
def test_dense_rider_matches_plain(card, qual_threshold):
    """B1's dense form with the dense rider (every family's QC length the
    padded width): live members' padding past their family's length holds
    PAD with qual 0, which votes N where the threshold fails it."""
    from consensuscruncher_tpu_torch.ops import consensus_dense
    from consensuscruncher_tpu_torch.parallel.batching import bucket_families

    rng = np.random.default_rng(40 + qual_threshold)
    fams = []
    for key in range(600):
        size = int(rng.integers(2, 12))
        lens = [int(rng.choice([90, 100, 100, 104])) for _ in range(size)]
        fams.append((key, [rng.integers(0, 5, ln).astype(np.uint8) for ln in lens],
                     [rng.integers(0, 41, ln).astype(np.uint8) for ln in lens]))
    cfg = consensus_vote.ConsensusConfig(qual_threshold=qual_threshold)
    for batch in bucket_families(iter(fams), max_batch=256):
        before = (consensus_vote.launches, consensus_vote.qc_launches)
        got, got_qc = consensus_dense.consensus_batch(batch, cfg, card, qc=True)
        assert (consensus_vote.launches, consensus_vote.qc_launches) == (
            before[0] + 1, before[1] + 1)
        want, want_qc = consensus_dense.consensus_batch(batch, cfg, torch.device("cpu"),
                                                        qc=True)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want) and torch.equal(got_qc.cpu(), want_qc)


def test_hamming_matcher_matches_plain(card):
    from consensuscruncher_tpu_torch.ops import singleton as hamming

    rng = np.random.default_rng(41)
    a = rng.integers(0, 3, (300, 12)).astype(np.uint8)
    b = rng.integers(0, 3, (700, 12)).astype(np.uint8)
    before = hamming.launches
    got = hamming.pairwise_hamming(a, b, tile=256, device=card)
    assert hamming.launches == before + 6  # 2 x 3 tiles
    assert np.array_equal(got, hamming.pairwise_hamming(a, b, device="cpu"))
    for mm in (1, 2):
        assert np.array_equal(hamming.best_matches(a, b, mm, device=card),
                              hamming.best_matches(a, b, mm, device="cpu"))
    codes = np.concatenate([a, b])
    qi = rng.integers(0, 1000, 200_000)
    pj = rng.integers(0, 1000, 200_000)
    got = hamming.pair_distances(codes, qi, pj, device=card, max_pairs=50_000)
    assert np.array_equal(got, hamming.pair_distances(codes, qi, pj, device="cpu"))


def test_dcs_walk_duplex_vote_matches_plain(card):
    """The window walks' batched duplex vote (``_duplex_vote_batch``) on
    the card against its plain version and the host oracle."""
    from consensuscruncher_tpu_torch.core.duplex_cpu import duplex_consensus
    from consensuscruncher_tpu_torch.stages.dcs_maker import _duplex_vote_batch

    rng = np.random.default_rng(42)
    s1, s2 = (rng.integers(0, 5, (5000, 100)).astype(np.uint8) for _ in range(2))
    s2 = np.where(rng.random(s1.shape) < 0.7, s1, s2).astype(np.uint8)
    q1, q2 = (rng.integers(0, 41, (5000, 100)).astype(np.uint8) for _ in range(2))
    got = _duplex_vote_batch(s1, q1, s2, q2, card)
    want = _duplex_vote_batch(s1, q1, s2, q2, torch.device("cpu"))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    for i in (0, 1, 4999):
        ob, oq = duplex_consensus(s1[i], q1[i], s2[i], q2[i])
        assert np.array_equal(got[0][i], ob) and np.array_equal(got[1][i], oq)


# ---------------------------------------------------- the vote policies


def _degraded_stream(rng, wire, sizes, length):
    """A member stream on ``wire`` whose families mostly agree, half the
    members below Phred 20 (so delegation and the distilled head decide
    differently from majority)."""
    m = int(sizes.sum()) + 9
    top = 4 if wire in ("pack4", "pack6") else 6
    bases = rng.integers(0, top, (m, length), dtype=np.uint8)
    start = 0
    for size in sizes:
        keep = rng.random((size, length)) < 0.75
        bases[start:start + size] = np.where(keep, bases[start], bases[start:start + size])
        start += size
    levels = {"raw": np.arange(3, 42, dtype=np.uint8),
              "pack8": np.array([3, 8, 12, 15, 20, 25, 30, 35, 40], np.uint8),
              "pack6": np.array([4, 9, 14, 22, 26, 30, 34, 38], np.uint8),
              "pack4": np.array([7, 12, 30, 37], np.uint8)}[wire]
    quals = rng.choice(levels, (m, length)).astype(np.uint8)
    a, b = encode_wire(wire, bases, quals)
    return torch.from_numpy(np.ascontiguousarray(a)), torch.from_numpy(b)


@pytest.mark.parametrize("policy", ["delegation", "distilled"])
@pytest.mark.parametrize("wire", WIRES)
def test_policy_stream_vote_on_card_matches_cpu(card, wire, policy):
    rng = np.random.default_rng(50 + WIRES.index(wire))
    length = 104
    # a batch at the main path's cap (16 slots), and one with a family of
    # 512 members, the largest the gather takes
    for sizes in (rng.integers(0, 12, 20000), np.array([3, 0, 512, 1, 9])):
        sizes = sizes.astype(np.int64)
        a, b = _degraded_stream(rng, wire, sizes, length)
        lengths = torch.from_numpy(rng.integers(60, length + 1, sizes.shape[0]))
        for cfg in (consensus_vote.ConsensusConfig(),
                    consensus_vote.ConsensusConfig(cutoff=0.5, qual_threshold=20)):
            before = consensus_vote.launches
            got = consensus_segment.stream_vote(wire, a.to(card),
                                                _book_or_quals(wire, b, card), sizes, cfg, 96,
                                                lengths, policy=policy)
            assert consensus_vote.launches == before  # the policies never launch B1
            assert got[0].device == a.to(card).device
            want = consensus_segment.stream_vote(wire, a, b, sizes, cfg, 96, lengths,
                                                 policy=policy)
            assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    with pytest.raises(ValueError, match="MAX_DENSE_CAP"):
        sizes[2] = 513
        consensus_segment.stream_vote(wire, a.to(card), _book_or_quals(wire, b, card), sizes,
                                      policy=policy)


@pytest.mark.parametrize("policy", ["delegation", "distilled"])
def test_policy_dense_and_duplex_on_card_match_cpu(card, policy):
    rng = np.random.default_rng(60)
    ba, qa, sa = _strand(rng, 4096, 16, 100, empty_every=7)
    bb, qb, sb = _strand(rng, 4096, 16, 100, empty_every=5)
    qa[:, ::2] = np.minimum(qa[:, ::2], 15)       # degraded members
    host = [torch.from_numpy(x) for x in (ba, qa, bb, qb)]
    dev = [x.to(card) for x in host]
    for qc in (False, True):
        got = consensus_vote.consensus_batch(dev[0], dev[1], sa, qc=qc, policy=policy)
        want = consensus_vote.consensus_batch(host[0], host[1], sa, qc=qc, policy=policy)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    before = consensus_vote.fused_launches
    got = consensus_vote.duplex_batch(dev[0], dev[1], sa, dev[2], dev[3], sb, policy=policy)
    assert consensus_vote.fused_launches == before  # B15 composes, B2 stays majority's
    want = consensus_vote.duplex_batch(host[0], host[1], sa, host[2], host[3], sb,
                                       policy=policy)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def test_host_workers_on_card_match_one_process(card, tmp_path):
    """``--host_workers 2`` on the card (each worker its own process and
    CUDA context on the card) writes the one-process card run's records;
    ``--resume True`` keeps the worker trees, whose SSCS sidecars say the
    votes ran on the card."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = str(tmp_path / "sample.bam")
    shutil.copy(os.path.join(repo, "test", "data", "sample.bam"), src)
    common = ["consensus", "-i", src, "-n", "s", "--scorrect", "True", "--device", "cuda"]
    cli_main(common + ["-o", str(tmp_path / "one")])
    res = cli_main(common + ["-o", str(tmp_path / "two"), "--host_workers", "2",
                             "--resume", "True"])
    assert res["pipeline"] == "host_sharded[2]"
    one, two = tmp_path / "one" / "s", tmp_path / "two" / "s"
    bams = sorted(os.path.relpath(os.path.join(r, f), one)
                  for r, _d, files in os.walk(one) for f in files if f.endswith(".bam"))
    assert len(bams) == 11
    for rel in bams:
        assert _records(str(two / rel)) == _records(str(one / rel)), rel
    for i in range(2):
        with open(two / ".ranges" / f"r{i}" / "sscs" / f"r{i}.metrics.json") as fh:
            doc = json.load(fh)
        assert doc["backend"] == "cuda" and doc["cumulative"]["bytes_h2d"] > 0


def test_devices_2_on_card_match_one_device(card, tmp_path):
    """``--devices 2`` on the card (two shards, on one card when it is the
    only one) writes the one-device card run's records, with one SSCS
    launch per shard that holds families."""
    from consensuscruncher_tpu_torch.parallel import mesh as mesh_mod

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    common = ["consensus", "-i", os.path.join(repo, "test", "data", "sample.bam"), "-n", "s",
              "--scorrect", "True", "--device", "cuda"]
    cli_main(common + ["-o", str(tmp_path / "one")])
    before = consensus_vote.launches
    cli_main(common + ["-o", str(tmp_path / "two"), "--devices", "2"])
    assert consensus_vote.launches > before
    one, two = tmp_path / "one" / "s", tmp_path / "two" / "s"
    bams = sorted(os.path.relpath(os.path.join(r, f), one)
                  for r, _d, files in os.walk(one) for f in files if f.endswith(".bam"))
    assert len(bams) == 11
    for rel in bams:
        assert _records(str(two / rel)) == _records(str(one / rel)), rel

    rng = np.random.default_rng(8)
    b, f, length = 64, 8, 100
    bases = rng.integers(0, 5, (b, f, length)).astype(np.uint8)
    quals = rng.integers(2, 41, (b, f, length)).astype(np.uint8)
    sizes = rng.integers(0, f + 1, b).astype(np.int32)
    mesh = mesh_mod.make_mesh(devices=[torch.device("cuda", 0)] * 2)
    got_b, got_q, stats = mesh_mod.sharded_consensus_batch(bases, quals, sizes, mesh)
    want_b, want_q = consensus_vote.consensus_batch(
        torch.from_numpy(bases).to(card), torch.from_numpy(quals).to(card), sizes)
    assert torch.equal(got_b, want_b) and torch.equal(got_q, want_q)
    assert stats.families == int((sizes > 0).sum())


def test_served_gang_on_card_matches_cpu_served(card, tmp_path):
    """A gang of three jobs through the daemon's scheduler on the card (B1
    dense launched for the gang) writes the records of the same gang served
    on the CPU; ``CCT_SANITIZE=1`` guards the card's stages meanwhile."""
    from consensuscruncher_tpu_torch.serve.scheduler import Scheduler

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = os.path.join(repo, "test", "data")
    inputs = [os.path.join(data, f"{n}.bam") for n in ("sample", "sample_adversarial",
                                                        "sample_bcerr")]
    trees = {}
    os.environ["CCT_SANITIZE"] = "1"
    try:
        for device in ("cuda", "cpu"):
            sched = Scheduler(paused=True, gang_size=4, device=device)
            jobs = [sched.submit({"input": p, "output": str(tmp_path / device)}) for p in inputs]
            before = consensus_vote.launches
            sched.release()
            for job in jobs:
                sched.wait(job.id, timeout=600)
                assert job.state == "done", job.error
                assert job.gang_size == 3
            if device == "cuda":
                assert consensus_vote.launches > before
            sched.close()
            trees[device] = tmp_path / device
    finally:
        os.environ.pop("CCT_SANITIZE", None)
    for p in inputs:
        name = os.path.basename(p).split(".")[0]
        one, two = trees["cpu"] / name, trees["cuda"] / name
        bams = sorted(os.path.relpath(os.path.join(r, f), one)
                      for r, _d, files in os.walk(one) for f in files if f.endswith(".bam"))
        assert len(bams) == 11
        for rel in bams:
            assert _records(str(two / rel)) == _records(str(one / rel)), (name, rel)


def test_routed_jobs_and_a_cache_hit_on_card(card, tmp_path):
    """The router over two in-process daemons on the card with one cache
    plane: ``sample.bam`` holds the goldens; the same question from
    another tenant is answered from the plane with no launch, its BAMs the
    first tree's bytes."""
    from consensuscruncher_tpu_torch.serve.router import Router
    from consensuscruncher_tpu_torch.serve.scheduler import Scheduler
    from consensuscruncher_tpu_torch.serve.server import ServeServer
    from consensuscruncher_tpu_torch.utils.digest import golden_mismatches

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "test", "golden.json")) as fh:
        golden = json.load(fh)["consensus"]
    spec = {"input": os.path.join(repo, "test", "data", "sample.bam"),
            "output": str(tmp_path / "a"), "name": "golden"}
    plane = str(tmp_path / "plane")
    scheds, servers, members = [], [], []
    for w in ("w0", "w1"):
        scheds.append(Scheduler(gang_size=4, device="cuda", node=w, result_cache=plane))
        servers.append(ServeServer(scheds[-1], socket_path=str(tmp_path / f"{w}.sock")))
        servers[-1].start()
        members.append((w, str(tmp_path / f"{w}.sock")))
    router = Router(members, start_monitor=False, result_cache=plane)
    try:
        router.probe_members()
        before = consensus_vote.launches
        sub = router.submit(spec)
        assert router.result({"key": sub["key"], "timeout": 600})["job"]["state"] == "done"
        assert consensus_vote.launches > before
        assert golden_mismatches(str(tmp_path / "a" / "golden"), golden) == []
        before = consensus_vote.launches
        hit = router.submit(dict(spec, output=str(tmp_path / "b"), tenant="other"))
        assert hit["cached"] is True and consensus_vote.launches == before
    finally:
        router.close()
        for server, sched in zip(servers, scheds):
            server.close()
            sched.close(timeout=120)
    one, two = tmp_path / "a" / "golden", tmp_path / "b" / "golden"
    bams = sorted(os.path.relpath(os.path.join(r, f), one)
                  for r, _d, files in os.walk(one) for f in files if f.endswith(".bam"))
    assert len(bams) == 11
    for rel in bams:
        with open(one / rel, "rb") as a, open(two / rel, "rb") as b:
            assert a.read() == b.read(), rel


def _tree_records(base):
    bams = sorted(os.path.relpath(os.path.join(r, f), base)
                  for r, _d, files in os.walk(base) for f in files if f.endswith(".bam"))
    return {rel: _records(os.path.join(base, rel)) for rel in bams}


def test_fastq_to_dcs_on_card_matches_cpu(card, tmp_path):
    """``simulate_fastq_pairs`` -> ``fastq2bam --bwa builtin --host_workers
    2`` (host only) -> ``consensus`` on the card: every BAM record by
    record equal to the ``--device cpu`` run's, through the object walks
    (the aligner writes ``NM`` on every read), with B1 launched."""
    from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_fastq_pairs

    r1, r2, fa = simulate_fastq_pairs(str(tmp_path / "sim"), SimConfig(
        n_fragments=400, ref_len=40 * 400 + 4000, seed=43))
    res = cli_main(["fastq2bam", "-f1", r1, "-f2", r2, "-o", str(tmp_path / "f"), "-n", "s",
                    "-r", fa, "--bwa", "builtin", "--bpattern", "NNNNNNT",
                    "--host_workers", "2"])
    trees = {}
    for device in ("cuda", "cpu"):
        before = consensus_vote.launches
        cli_main(["consensus", "-i", res["bam"], "-o", str(tmp_path / device), "-n", "s",
                  "--scorrect", "True", "--device", device])
        if device == "cuda":
            assert consensus_vote.launches > before
        trees[device] = _tree_records(str(tmp_path / device / "s"))
    assert len(trees["cuda"]) == 11 and trees["cuda"] == trees["cpu"]


def test_sscs_entry_on_card_matches_cpu(card, tmp_path):
    """``sscs_maker.main --device cuda`` on ``sample.bam`` (B1 launched)
    writes the ``--device cpu`` entry's records and stats less backend."""
    from consensuscruncher_tpu_torch.stages import sscs_maker

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for device in ("cuda", "cpu"):
        os.makedirs(tmp_path / device)
        before = consensus_vote.launches
        sscs_maker.main(["--infile", os.path.join(repo, "test", "data", "sample.bam"),
                         "--outfile", str(tmp_path / device / "x"), "--device", device])
        assert (consensus_vote.launches > before) == (device == "cuda")
    assert _tree_records(str(tmp_path / "cuda")) == _tree_records(str(tmp_path / "cpu"))
    for name in ("x.sscs_stats.txt", "x.read_families.txt"):
        got, want = ((tmp_path / d / name).read_text().splitlines() for d in ("cuda", "cpu"))
        assert [ln for ln in got if "backend" not in ln] == \
            [ln for ln in want if "backend" not in ln]


def test_critpath_job_and_top_over_a_card_daemon(card, tmp_path, capsys):
    """A ``serve`` daemon on the card (its own process, ``CCT_TRACE=1``)
    serves ``sample.bam``; ``critpath job <key>`` read over its socket
    prints the job's chain (segments summing to its wall), and ``top
    --once`` renders a frame of its exposition."""
    import subprocess
    import sys
    import time

    from consensuscruncher_tpu_torch.obs import critpath
    from consensuscruncher_tpu_torch.serve.client import ServeClient

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sock = str(tmp_path / "d.sock")
    env = dict(os.environ, CCT_TRACE="1", CCT_TRACE_DIR=str(tmp_path / "traces"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "serve", "--socket", sock,
         "--journal", str(tmp_path / "j.wal")], cwd=repo, env=env)
    try:
        deadline = time.monotonic() + 600
        while not os.path.exists(sock):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        client = ServeClient(sock)
        sub = client.submit_full({"input": os.path.join(repo, "test", "data", "sample.bam"),
                                  "output": str(tmp_path / "out"), "name": "golden"})
        job = client.result(key=sub["key"], timeout=600)
        assert job["state"] == "done"
        assert client.metrics()["kernel_launches"]["vote"] > 0
        capsys.readouterr()
        cli_main(["critpath", "job", sub["key"], "--socket", sock])
        chain = capsys.readouterr().out
        assert chain.startswith(f"job {sub['job_id']} key={sub['key']} state=done")
        events = client.request({"op": "trace"})["trace"]["events"]
        (doc,) = critpath.from_events(events)
        assert abs(sum(s["ms"] for s in doc["segments"]) - doc["wall_ms"]) <= 1.0
        with pytest.raises(SystemExit) as exc:
            cli_main(["top", "--once", "True", "--socket", sock])
        assert exc.value.code == 0
        assert capsys.readouterr().out.startswith(f"cct top — unix:{sock}")
    finally:
        proc.terminate()
        proc.wait(timeout=120)


@pytest.mark.parametrize("max_batch,member_limit", [(4096, 32768), (64, 512)])
def test_consensus_families_stream_on_card_matches_cpu(card, max_batch, member_limit):
    """The library's member-stream entry: each batch one B1 launch on the
    card, equal family by family to its ``device="cpu"`` run."""
    rng = np.random.default_rng(max_batch)
    fams = []
    for key in range(3000):
        size = int(rng.integers(1, 9))
        length = int(rng.choice([64, 100, 151]))
        truth = rng.integers(0, 4, length, dtype=np.uint8)
        seqs = [np.where(rng.random(length) < 0.9, truth,
                         rng.integers(0, 5, length)).astype(np.uint8) for _ in range(size)]
        fams.append((key, seqs, [rng.integers(2, 41, length, dtype=np.uint8)
                                 for _ in range(size)]))
    cfg = consensus_vote.ConsensusConfig()
    before = consensus_vote.launches
    got = list(consensus_segment.consensus_families_stream(
        iter(fams), cfg, card, max_batch=max_batch, member_limit=member_limit))
    assert consensus_vote.launches > before
    want = list(consensus_segment.consensus_families_stream(
        iter(fams), cfg, torch.device("cpu"), max_batch=max_batch, member_limit=member_limit))
    assert [k for k, _b, _q in got] == [k for k, _b, _q in want]
    for (_k, gb, gq), (_w, wb, wq) in zip(got, want):
        assert np.array_equal(gb, wb) and np.array_equal(gq, wq)


@pytest.mark.parametrize("with_qc", [False, True])
def test_majority_family_vote_on_card_matches_plain(card, with_qc):
    """The per-family vote: one B1 dense launch per call on the card,
    equal to its plain version on the CPU."""
    from consensuscruncher_tpu_torch.policies import majority_family_vote

    rng = np.random.default_rng(14 + with_qc)
    kw = dict(num=7, den=10, qual_threshold=20, qual_cap=60, with_qc=with_qc)
    for f in range(1, 17):
        for length in (1, 1 + (41 * f) % 130, 130):
            bases = rng.integers(0, 6, (f, length), dtype=np.uint8)
            quals = rng.integers(0, 45, (f, length), dtype=np.uint8)
            size = int(rng.integers(0, f + 1))
            before = consensus_vote.launches
            got = majority_family_vote(torch.from_numpy(bases).to(card),
                                       torch.from_numpy(quals).to(card), size, **kw)
            assert consensus_vote.launches == before + 1
            want = majority_family_vote(torch.from_numpy(bases), torch.from_numpy(quals),
                                        size, **kw)
            assert len(got) == len(want) == (4 if with_qc else 2)
            for g, w in zip(got, want):
                assert g.device.type == "cuda" and torch.equal(g.cpu(), w)


def test_distill_training_on_card_follows_cpu(card, monkeypatch):
    """20 full-batch steps of the trainer on the card against the same
    steps on the CPU: every step's loss within 1e-5 relative, the weights
    within 1e-5."""
    import argparse
    import contextlib
    import io

    from consensuscruncher_tpu_torch.policies import distill_train

    real = distill_train.loss_and_grads
    runs = {}
    for dev in ("cuda", "cpu"):
        args = argparse.Namespace(seed=17, samples=24_000, hidden=16, steps=20, lr=0.01,
                                  device=dev)
        losses: list = []

        def recording(params, x, y, losses=losses):
            loss, grads = real(params, x, y)
            losses.append(float(loss))
            return loss, grads

        monkeypatch.setattr(distill_train, "loss_and_grads", recording)
        with contextlib.redirect_stderr(io.StringIO()):
            params, accuracy = distill_train.train(args)
        runs[dev] = (params, accuracy, np.array(losses))
    (gp, ga, gl), (wp, wa, wl) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=0)
    for key in wp:
        np.testing.assert_allclose(gp[key], wp[key], rtol=0, atol=1e-5)
    for name, row in wa.items():
        assert ga[name]["n"] == row["n"]
        assert abs(ga[name]["distilled"] - row["distilled"]) <= 1e-3


def test_accuracy_harness_on_card_matches_cpu(card, tmp_path, monkeypatch):
    """The truth-set harness at 40 fragments, all three policies: the card's
    ``accuracy`` and ``qc`` sections equal the ``--device cpu`` artifact's."""
    import contextlib
    import io

    from consensuscruncher_tpu_torch.utils import accuracy_harness

    monkeypatch.delenv("CCT_QC", raising=False)  # the harness sets it per run
    monkeypatch.delenv("CCT_DISTILLED_CHECKPOINT", raising=False)
    docs = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.json"
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            assert accuracy_harness.main([
                "--fragments", "40", "--repeats", "1", "--degraded_rate", "0.5",
                "--policies", "majority,delegation,distilled", "--device", device,
                "--workdir", str(tmp_path / device), "--out", str(out)]) == 0
        docs[device] = json.loads(out.read_text())
    assert docs["cuda"]["config"]["device"] == "cuda"
    assert set(docs["cuda"]["accuracy"]["policies"]) == {"majority", "delegation", "distilled"}
    for key in ("accuracy", "qc"):
        assert docs["cuda"][key] == docs["cpu"][key]


def test_serve_soak_on_card(card, tmp_path, monkeypatch):
    """The soak on the card: the kill -9 lands while the jobs are in flight,
    the supervised daemon restarts, replays them from its journal (a
    ``journal-replay`` flight dump) and finishes each to the goldens, its
    B1 launches on the card (its metrics read as the soak signals it)."""
    import contextlib
    import glob
    import io
    import signal

    from consensuscruncher_tpu_torch.serve.client import ServeClient
    from consensuscruncher_tpu_torch.utils import serve_soak

    sent = []
    real_kill = os.kill

    def kill(pid, sig):
        try:
            if sig in (signal.SIGKILL, signal.SIGTERM):
                sent.append(ServeClient(str(tmp_path / "soak.sock"), retries=2).metrics())
        finally:
            real_kill(pid, sig)

    for var in [k for k in os.environ if k.startswith("CCT_")]:
        monkeypatch.delenv(var)  # the daemon inherits them (CCT_TRACE_DIR moves its dumps)
    monkeypatch.setattr(serve_soak.os, "kill", kill)
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        rc = serve_soak.main(["--jobs", "3", "--seed", "7", "--kill-after", "0.2",
                              "--workdir", str(tmp_path)])
    assert rc == 0, (tmp_path / "daemon.log").read_text()[-3000:]
    (_, drained) = sent
    assert drained["cumulative"]["jobs_replayed"] >= 1
    reasons = [json.load(open(p))["reason"] for p in glob.glob(str(tmp_path / "flight-*.json"))]
    assert "journal-replay" in reasons
    assert drained["kernel_launches"]["vote"] > 0
