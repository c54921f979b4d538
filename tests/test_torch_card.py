"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a card.  Imports no JAX, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from consensuscruncher_tpu_torch.ops import consensus_segment, consensus_vote
from consensuscruncher_tpu_torch.ops.packing import build_codebook4, pack4
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
