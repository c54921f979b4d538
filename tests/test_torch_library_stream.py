"""The library's member-stream entries and batch calls, against the JAX package.

On seeded numpy families (sizes 1..12, members shorter and longer than
their modal length) and on the family blocks of ``test/data/sample.bam``:

- ``parallel.batching.bucket_members`` equals the JAX one batch by batch
  (keys, rows, quals, sizes, lengths, counts) at several ``max_batch`` /
  ``member_limit`` values, and refuses an empty family with the JAX
  message;
- ``ops.consensus_segment.consensus_families_stream`` and
  ``consensus_blocks_stream`` under ``device="cpu"`` (B1's plain version)
  yield what the JAX functions yield, family by family; the empty stream
  yields nothing;
- ``derive_ids_device``, ``ops.consensus_dense.consensus_batch_host``,
  ``qc_member_reduction`` and ``ops.duplex.duplex_batch`` equal the JAX
  functions on the CPU.

All integer: exact equality.
"""

import os

import numpy as np
import pytest
import torch

from consensuscruncher_tpu.io.columnar import ColumnarReader as JaxColumnarReader
from consensuscruncher_tpu.ops import consensus_segment as jseg
from consensuscruncher_tpu.ops import consensus_tpu as jax_ct
from consensuscruncher_tpu.ops import duplex_tpu as jax_duplex
from consensuscruncher_tpu.parallel import batching as jax_batching
from consensuscruncher_tpu.stages import grouping as jax_grouping
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.ops import consensus_dense, consensus_segment, duplex
from consensuscruncher_tpu_torch.ops.consensus_vote import ConsensusConfig
from consensuscruncher_tpu_torch.parallel import batching
from consensuscruncher_tpu_torch.stages import grouping
from consensuscruncher_tpu_torch.utils.phred import PAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")
CPU = torch.device("cpu")


def _families(seed, n=120):
    """``(key, seqs, quals)``: sizes 1..12, member lengths around the
    family's own (ties between two lengths included), a shared truth with
    noise so that votes pass and fail."""
    rng = np.random.default_rng(seed)
    out = []
    for key in range(n):
        size = int(rng.integers(1, 13))
        base_len = int(rng.choice([31, 64, 90, 100, 150]))
        lens = [base_len + int(rng.choice([0, 0, 0, -3, 5])) for _ in range(size)]
        truth = rng.integers(0, 4, size=max(lens), dtype=np.uint8)
        seqs = []
        for ln in lens:
            s = rng.integers(0, 5, size=ln, dtype=np.uint8)
            keep = rng.random(ln) < 0.85
            s[keep] = truth[:ln][keep]
            seqs.append(s)
        quals = [rng.integers(0, 41, size=ln, dtype=np.uint8) for ln in lens]
        out.append((key, seqs, quals))
    return out


def _batch_fields(b):
    return (list(b.keys), b.rows.tobytes(), b.rows.shape, b.qrows.tobytes(),
            b.sizes.tolist(), b.lengths.tolist(), b.n_real, b.n_members)


@pytest.mark.parametrize("max_batch,member_limit", [(1024, 8192), (8, 8192), (16, 40), (3, 5)])
def test_bucket_members_equals_jax_batch_by_batch(max_batch, member_limit):
    fams = _families(1)
    got = list(batching.bucket_members(iter(fams), max_batch, member_limit))
    want = list(jax_batching.bucket_members(iter(fams), max_batch, member_limit))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert _batch_fields(g) == _batch_fields(w)


def test_bucket_members_refuses_an_empty_family():
    fams = [(0, [np.zeros(4, np.uint8)], [np.zeros(4, np.uint8)]), ("k", [], [])]
    with pytest.raises(ValueError, match="empty family for key 'k'") as got:
        list(batching.bucket_members(iter(fams)))
    with pytest.raises(ValueError) as want:
        list(jax_batching.bucket_members(iter(fams)))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="empty family"):
        list(consensus_segment.consensus_families_stream(iter(fams), ConsensusConfig(), CPU))


def _same_stream(got, want):
    assert len(got) == len(want)
    for (gk, gb, gq), (wk, wb, wq) in zip(got, want):
        assert gk == wk
        np.testing.assert_array_equal(gb, np.asarray(wb))
        np.testing.assert_array_equal(gq, np.asarray(wq))


@pytest.mark.parametrize("max_batch,member_limit", [(4096, 32768), (8, 64), (5, 7)])
@pytest.mark.parametrize("cutoff,qual_threshold", [(0.7, 0), (0.6, 20)])
def test_consensus_families_stream_equals_jax(max_batch, member_limit, cutoff,
                                              qual_threshold):
    fams = _families(2)
    cfg = ConsensusConfig(cutoff=cutoff, qual_threshold=qual_threshold)
    jcfg = jax_ct.ConsensusConfig(cutoff=cutoff, qual_threshold=qual_threshold)
    got = list(consensus_segment.consensus_families_stream(
        iter(fams), cfg, CPU, max_batch=max_batch, member_limit=member_limit))
    want = list(jseg.consensus_families_stream(
        iter(fams), jcfg, max_batch=max_batch, member_limit=member_limit, prefetch_depth=0))
    _same_stream(got, want)
    assert sorted(k for k, _b, _q in got) == list(range(len(fams)))


def test_consensus_families_stream_of_nothing_yields_nothing():
    assert list(consensus_segment.consensus_families_stream(iter([]), ConsensusConfig(),
                                                            CPU)) == []
    assert list(consensus_segment.consensus_blocks_stream(iter([]), ConsensusConfig(),
                                                          CPU)) == []


def _block_items(reader_cls, group_mod):
    """``(block, fam_idx, keys)`` of every family block of sample.bam,
    keys ``(block number, family index)``."""
    items = []
    with reader_cls(SAMPLE) as reader:
        n = 0
        for kind, a, _b in group_mod.stream_family_blocks(reader, reader.header, "|"):
            if kind == "bad":
                continue
            multi = np.nonzero(a.sizes >= 2)[0]
            if len(multi):
                items.append((a, multi, [(n, int(j)) for j in multi]))
            n += 1
    return items


@pytest.mark.parametrize("max_batch,member_limit", [(4096, 32768), (16, 64)])
def test_consensus_blocks_stream_equals_jax(max_batch, member_limit):
    got = list(consensus_segment.consensus_blocks_stream(
        iter(_block_items(ColumnarReader, grouping)), ConsensusConfig(), CPU,
        max_batch=max_batch, member_limit=member_limit))
    want = list(jseg.consensus_blocks_stream(
        iter(_block_items(JaxColumnarReader, jax_grouping)), jax_ct.ConsensusConfig(),
        max_batch=max_batch, member_limit=member_limit, prefetch_depth=0))
    _same_stream(got, want)
    assert len(got) > 100


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_derive_ids_device_equals_jax(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 9, size=int(rng.integers(1, 40))).astype(np.int32)
    total = int(sizes.sum())
    fam_ids, ranks = consensus_segment.derive_ids_device(torch.from_numpy(sizes), total)
    jf, jr = jseg.derive_ids_device(sizes, total)
    assert fam_ids.dtype == ranks.dtype == torch.int32
    np.testing.assert_array_equal(fam_ids.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jr))


def _dense_batch(seed, b=24, f=8, length=64):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, f + 1, size=b).astype(np.int32)
    bases = rng.integers(0, 5, size=(b, f, length), dtype=np.uint8)
    quals = rng.integers(0, 41, size=(b, f, length), dtype=np.uint8)
    truth = rng.integers(0, 4, size=(b, 1, length), dtype=np.uint8)
    bases = np.where(rng.random((b, f, length)) < 0.8, truth, bases).astype(np.uint8)
    slot = np.arange(f)[None, :, None] < sizes[:, None, None]
    bases = np.where(slot, bases, PAD).astype(np.uint8)
    quals = np.where(slot, quals, 0).astype(np.uint8)
    return bases, quals, sizes


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cutoff,qual_threshold", [(0.7, 0), (0.5, 25)])
def test_consensus_batch_host_equals_jax(seed, cutoff, qual_threshold):
    bases, quals, sizes = _dense_batch(seed)
    got = consensus_dense.consensus_batch_host(
        bases, quals, sizes, ConsensusConfig(cutoff=cutoff, qual_threshold=qual_threshold),
        CPU)
    want = jax_ct.consensus_batch_host(
        bases, quals, sizes, jax_ct.ConsensusConfig(cutoff=cutoff,
                                                    qual_threshold=qual_threshold))
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    assert (sizes == 0).any() and (got[0][sizes == 0] == 4).all()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("qual_threshold", [0, 30])
def test_qc_member_reduction_equals_jax(seed, qual_threshold):
    bases, quals, sizes = _dense_batch(seed)
    fb, fq = np.ascontiguousarray(bases.transpose(1, 0, 2)), np.ascontiguousarray(
        quals.transpose(1, 0, 2))
    votes, disagree = consensus_dense.qc_member_reduction(
        torch.from_numpy(fb), torch.from_numpy(fq), torch.from_numpy(sizes),
        qual_threshold=qual_threshold)
    jv, jd = jax_ct.qc_member_reduction(fb, fq, sizes, qual_threshold=qual_threshold)
    assert votes.dtype == disagree.dtype == torch.int32
    np.testing.assert_array_equal(votes.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(disagree.numpy(), np.asarray(jd))


@pytest.mark.parametrize("b,length", [(1, 1), (5, 33), (64, 100), (100, 150)])
def test_duplex_batch_equals_jax(b, length):
    rng = np.random.default_rng(b * 1000 + length)
    planes = [rng.integers(0, 5, size=(b, length), dtype=np.uint8),
              rng.integers(0, 61, size=(b, length), dtype=np.uint8)]
    planes += [np.where(rng.random((b, length)) < 0.7, planes[0],
                        rng.integers(0, 5, size=(b, length))).astype(np.uint8),
               rng.integers(0, 61, size=(b, length), dtype=np.uint8)]
    got = duplex.duplex_batch(*planes, qual_cap=60, device=CPU)
    want = np.asarray(jax_duplex.duplex_batch(*planes, qual_cap=60))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    host = duplex.duplex_batch_host(*planes, qual_cap=60, device=CPU)
    np.testing.assert_array_equal(np.stack(host), want[:, :b, :length])
