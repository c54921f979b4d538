"""B10, the Hamming barcode matcher of the rescue (``--max_mismatch > 0``).

- the port's ``pairwise_hamming`` / ``best_matches`` (their plain version,
  on the CPU) against the JAX package's (its jitted tile program on the
  XLA CPU, and its numpy form) on seeded barcodes: ties to ``-1``, an
  empty pool, ``max_mismatch`` 1 and 2, matrices larger than a tile;
- ``pair_distances`` against all-pairs distances, padded rows included;
- the rescue walk's decisions with the chunked distances (one call per
  chunk of windows, replayed on the host) equal the per-tag decisions
  (one ``best_matches`` call per singleton, the port's and the JAX
  package's ``_hamming_partner``), on the windows of
  ``sample_bcerr.bam`` and on seeded windows full of ties.

All integer: exact equality.
"""

import os

import numpy as np
import pytest
import torch

from consensuscruncher_tpu.ops import singleton_tpu as jax_hamming
from consensuscruncher_tpu.stages import singleton_correction as jax_sc
from consensuscruncher_tpu_torch.core.tags import FamilyTag
from consensuscruncher_tpu_torch.io.bam import BamRead, BamReader
from consensuscruncher_tpu_torch.ops import singleton as hamming
from consensuscruncher_tpu_torch.stages import singleton_correction as sc
from consensuscruncher_tpu_torch.stages.grouping import consensus_windows
from consensuscruncher_tpu_torch.stages.sscs_maker import run_sscs
from consensuscruncher_tpu_torch.utils.stats import StageStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _codes(rng, n, width, alphabet=5):
    return rng.integers(0, alphabet, size=(n, width), dtype=np.uint8)


@pytest.mark.parametrize("max_mismatch", [1, 2])
@pytest.mark.parametrize("n,m,alphabet", [(37, 45, 5), (20, 70, 2), (5, 3, 4)])
def test_best_matches_equal_jax(n, m, alphabet, max_mismatch):
    rng = np.random.default_rng(100 + n + m + max_mismatch)
    a, b = _codes(rng, n, 6, alphabet), _codes(rng, m, 6, alphabet)
    b[1] = b[0]  # a guaranteed tie for whichever query is nearest those two
    got = hamming.pairwise_hamming(a, b, tile=16, device=CPU)
    assert np.array_equal(got, jax_hamming.pairwise_hamming(a, b, tile=16, device=True))
    assert np.array_equal(got, jax_hamming.pairwise_hamming(a, b, device=False))
    best = hamming.best_matches(a, b, max_mismatch, tile=16, device=CPU)
    want = jax_hamming.best_matches(a, b, max_mismatch, tile=16, device=True)
    assert np.array_equal(best, want)
    assert (best == -1).any()


def test_ties_and_empty_pool_give_minus_one():
    a = np.array([[0, 1, 2, 3]], np.uint8)
    tie = np.array([[0, 1, 2, 0], [0, 1, 0, 3], [3, 3, 3, 3]], np.uint8)
    assert hamming.best_matches(a, tie, 1, device=CPU).tolist() == [-1]
    assert jax_hamming.best_matches(a, tie, 1, device=False).tolist() == [-1]
    unique = tie[1:]
    assert hamming.best_matches(a, unique, 1, device=CPU).tolist() == [0]
    assert hamming.best_matches(a, unique, 0, device=CPU).tolist() == [-1]
    empty = np.zeros((0, 4), np.uint8)
    assert hamming.best_matches(a, empty, 2, device=CPU).tolist() == [-1]
    assert jax_hamming.best_matches(a, empty, 2, device=False).tolist() == [-1]
    assert hamming.choose(np.zeros((2, 0), np.int32), 1).tolist() == [-1, -1]
    with pytest.raises(ValueError, match="barcode matrices"):
        hamming.pairwise_hamming(a, np.zeros((1, 5), np.uint8), device=CPU)


def test_pair_distances_equal_all_pairs():
    rng = np.random.default_rng(7)
    codes = _codes(rng, 30, 8, 3)
    codes[5:9, 6:] = 0xFF  # shorter barcodes, padded
    qi = rng.integers(0, 30, size=500)
    pj = rng.integers(0, 30, size=500)
    full = hamming.pairwise_hamming_plain(codes, codes)
    got = hamming.pair_distances(codes, qi, pj, device=CPU)
    assert got.dtype == np.int32 and np.array_equal(got, full[qi, pj])
    assert hamming.pair_distances(codes, qi[:0], pj[:0], device=CPU).shape == (0,)


class _Recorder:
    """The walk's sinks: what it wrote to ``remaining`` and which
    corrections it asked for, in order."""

    def __init__(self):
        self.events = []
        self.writers = {"remaining": self}

    def write(self, read):
        self.events.append(("remaining", read.qname, read.flag))

    def add(self, route, read, partner):
        self.events.append((route, read.qname, read.flag, partner.qname, partner.flag))


def _decisions(windows, max_mismatch, mode):
    rec, stats = _Recorder(), StageStats("singleton_correction")
    if mode == "chunked":
        for chunk in sc._window_chunks(iter(windows), max_pairs=64):
            for (singles, sscses), dist in zip(chunk, sc._chunk_distances(chunk, CPU)):
                sc._walk_window(singles, sscses, stats, rec.writers, rec, max_mismatch,
                                lambda tag, cands, pool, d=dist: d.partner(
                                    tag, cands, pool, max_mismatch))
        return rec.events, stats
    if mode == "port":
        def partner(tag, cands, pool):
            return sc._hamming_partner(tag, cands, max_mismatch, CPU)
    else:
        def partner(tag, cands, pool):
            return jax_sc._hamming_partner(tag, cands, max_mismatch, True)
    for singles, sscses in windows:
        sc._walk_window(singles, sscses, stats, rec.writers, rec, max_mismatch, partner)
    return rec.events, stats


def _assert_same_decisions(windows, max_mismatch):
    chunked, stats = _decisions(windows, max_mismatch, "chunked")
    for mode in ("port", "jax"):
        events, other = _decisions(windows, max_mismatch, mode)
        assert events == chunked, mode
        assert other._items == stats._items, mode
    return chunked, stats


@pytest.fixture(scope="module")
def bcerr_windows(tmp_path_factory):
    td = tmp_path_factory.mktemp("bcerr")
    res = run_sscs(os.path.join(REPO, "test", "data", "sample_bcerr.bam"), str(td / "s"), CPU)
    with BamReader(res.singleton_bam) as s_reader, BamReader(res.sscs_bam) as x_reader:
        return list(sc._merge_windows(consensus_windows(s_reader),
                                      consensus_windows(x_reader)))


@pytest.mark.parametrize("max_mismatch", [1, 2])
def test_chunked_walk_equals_per_tag_walk_on_bcerr(bcerr_windows, max_mismatch):
    events, stats = _assert_same_decisions(bcerr_windows, max_mismatch)
    assert stats.get("rescued_by_sscs") > 0 and stats.get("remaining") > 0


def _random_windows(seed, n_windows=60):
    """Windows of few mates and a two-letter barcode alphabet: many
    candidates at equal distance, and a few partners of another length."""
    rng = np.random.default_rng(seed)
    windows = []
    for w in range(n_windows):
        pools = []
        for kind in range(2):
            pool = {}
            for k in range(int(rng.integers(0, 9))):
                half = ["".join(rng.choice(list("AC"), 3)) for _ in range(2)]
                tag = FamilyTag(barcode=".".join(half), ref="chr1", pos=100 * w,
                                mate_ref="chr1", mate_pos=int(rng.integers(0, 2)) + 500,
                                read_number=int(rng.integers(1, 3)),
                                orientation=str(rng.choice(["fwd", "rev"])))
                length = 12 if rng.random() < 0.1 else 10
                pool[tag] = BamRead(qname=f"w{w}k{kind}r{k}", flag=99 + kind,
                                    seq="A" * length)
            pools.append(pool)
        windows.append((pools[0], pools[1]))
    return windows


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("max_mismatch", [1, 2])
def test_chunked_walk_equals_per_tag_walk_with_ties(seed, max_mismatch):
    events, stats = _assert_same_decisions(_random_windows(seed), max_mismatch)
    assert stats.get("singletons_total") > 100
