"""The dense wire (``--wire dense``) of the port, against the JAX package.

- ``parallel.batching.bucket_families`` equals the JAX one bucket by
  bucket (keys, bases, quals, sizes, lengths) on seeded families whose
  members are shorter and longer than their modal length: short members
  pad with (N, qual 0) up to it, every cell past it with (PAD, qual 0);
- ``ops.consensus_dense.consensus_families`` (B1's dense form, its plain
  version here) yields what the JAX ``consensus_families`` yields;
- the dense QC rider equals the JAX ``majority_family_vote(with_qc=True)``
  summed over each batch, at ``--qualscore`` 0 and 30 (at 30 a live
  member's padding past its family's length votes N: no length mask);
- ``run_sscs(wire="dense")`` writes the stream wire's bytes.

All integer: exact equality.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from consensuscruncher_tpu.ops import consensus_tpu as jax_ct
from consensuscruncher_tpu.parallel import batching as jax_batching
from consensuscruncher_tpu_torch.obs import qc as obs_qc
from consensuscruncher_tpu_torch.ops import consensus_dense
from consensuscruncher_tpu_torch.ops.consensus_vote import ConsensusConfig
from consensuscruncher_tpu_torch.parallel import batching
from consensuscruncher_tpu_torch.stages.sscs_maker import run_sscs
from consensuscruncher_tpu_torch.utils.phred import PAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _families(seed, n=90):
    """``(key, seqs, quals)`` with sizes 2..12 and member lengths around
    a family's own length (ties between two lengths included)."""
    rng = np.random.default_rng(seed)
    out = []
    for key in range(n):
        size = int(rng.integers(2, 13))
        base_len = int(rng.choice([31, 64, 90, 100]))
        lens = [base_len + int(rng.choice([0, 0, 0, -3, 5])) for _ in range(size)]
        seqs = [rng.integers(0, 5, size=ln, dtype=np.uint8) for ln in lens]
        # a shared truth so the votes pass, with noise
        truth = rng.integers(0, 4, size=max(lens), dtype=np.uint8)
        for s in seqs:
            keep = rng.random(s.shape[0]) < 0.85
            s[keep] = truth[:s.shape[0]][keep]
        quals = [rng.integers(0, 41, size=ln, dtype=np.uint8) for ln in lens]
        out.append((key, seqs, quals))
    return out


def test_bucket_families_equal_jax():
    fams = _families(1)
    got = list(batching.bucket_families(iter(fams), max_batch=8))
    want = list(jax_batching.bucket_families(iter(fams), max_batch=8))
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g.keys == w.keys
        for field in ("bases", "quals", "fam_sizes", "lengths"):
            assert np.array_equal(getattr(g, field), getattr(w, field)), field
    # short members padded with N up to the modal length, PAD past it
    assert any((b.bases == PAD).any() and (b.bases == 4).any() for b in got)
    assert [batching.consensus_length(x) for x in ([3, 5, 5, 3], [2])] == [5, 2]
    assert [batching.len_bucket(x) for x in (1, 32, 33)] == [32, 32, 64]
    assert [batching.fam_bucket(x) for x in (1, 3, 8)] == [1, 4, 8]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("qualscore", [0, 30])
def test_consensus_families_equal_jax(depth, qualscore):
    fams = _families(2)
    cfg = ConsensusConfig(qual_threshold=qualscore)
    got = list(consensus_dense.consensus_families(iter(fams), cfg, CPU, max_batch=16,
                                                  prefetch_depth=depth))
    want = list(jax_ct.consensus_families(
        iter(fams), jax_ct.ConsensusConfig(qual_threshold=qualscore), max_batch=16,
        prefetch_depth=depth))
    assert [k for k, _b, _q in got] == [k for k, _b, _q in want]
    for (_k, gb, gq), (_k2, wb, wq) in zip(got, want):
        assert np.array_equal(gb, np.asarray(wb)) and np.array_equal(gq, np.asarray(wq))


@pytest.mark.parametrize("qualscore", [0, 30])
def test_dense_rider_equals_jax_with_qc(qualscore):
    cfg = ConsensusConfig(qual_threshold=qualscore)
    num, den = cfg.cutoff_rational
    fn = jax_ct._compiled_batch_fn(num, den, qualscore, cfg.qual_cap, True, "majority")
    batches = list(batching.bucket_families(iter(_families(3)), max_batch=8))
    differs = False
    for batch in batches:
        planes, sums = consensus_dense.consensus_batch(batch, cfg, CPU, qc=True)
        out_b, out_q, votes, disagree = (np.asarray(x) for x in fn(
            batch.bases, batch.quals, batch.fam_sizes))
        n = batch.n_real
        assert np.array_equal(planes[0].numpy(), out_b[:n])
        assert np.array_equal(planes[1].numpy(), out_q[:n])
        assert np.array_equal(sums[0].numpy(), votes) and np.array_equal(sums[1].numpy(), disagree)
        # no length mask: at qualscore 30 a live member's padding votes N
        lengths = batch.lengths[:n]
        differs |= bool((lengths < batch.bases.shape[2]).any() and qualscore > 0)
    assert differs == (qualscore > 0)


def test_dense_rider_feeds_the_sink():
    """``consensus_families`` sums the batches' riders into one handle."""
    cfg = ConsensusConfig(qual_threshold=30)
    fams = _families(4)
    acc = obs_qc.QcAccumulator()
    obs_qc.set_plane_sink(acc)
    try:
        list(consensus_dense.consensus_families(iter(fams), cfg, CPU, max_batch=8))
    finally:
        obs_qc.set_plane_sink(None)
    num, den = cfg.cutoff_rational
    fn = jax_ct._compiled_batch_fn(num, den, 30, cfg.qual_cap, True, "majority")
    want = obs_qc.QcAccumulator()
    for batch in jax_batching.bucket_families(iter(fams), max_batch=8):
        _b, _q, votes, disagree = fn(batch.bases, batch.quals, batch.fam_sizes)
        want.add_plane(np.asarray(votes), np.asarray(disagree))
    assert acc.plane_doc() == want.plane_doc()


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.mark.parametrize("bam", ["sample.bam", "sample_adversarial.bam"])
def test_run_sscs_dense_equals_stream(tmp_path, bam):
    path = os.path.join(REPO, "test", "data", bam)
    stream = run_sscs(path, str(tmp_path / "stream"), CPU)
    dense = run_sscs(path, str(tmp_path / "dense"), CPU, wire="dense")
    for attr in ("sscs_bam", "singleton_bam", "bad_bam"):
        assert _sha(getattr(dense, attr)) == _sha(getattr(stream, attr)), attr
    assert dense.stats._items == stream.stats._items
    with pytest.raises(ValueError, match="unknown wire"):
        run_sscs(path, str(tmp_path / "x"), CPU, wire="sparse")
