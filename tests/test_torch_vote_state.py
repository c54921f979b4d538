"""The vote kernels' tally (``csrc/vote_state.cuh``) against the plain vote.

``vote_state.cuh`` is plain C++ apart from its ``__device__`` qualifiers, so
it is compiled here for the host with the system C++ compiler, inside a
small driver that folds every member of a family into the tally the kernels
pick (``PackedTally`` up to ``kPackedMax`` members, else ``WideTally``) and
finalizes it, and also folds every family into a ``WideTally``.  Both are
held to ``consensus_vote.vote_members_plain`` on member streams made from a
seed: ties at the top count under cutoffs of 1/2 and less, PAD and N bases,
quals on both sides of the threshold, and families past ``kPackedMax``.
The QC rider's part of both tallies (``qc()``: the members in a lane and the
top count, whether the vote passes or not) is held to the plain version's
rider, family by family and summed under per-family length masks.
The outputs are integers: every comparison is exact.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from consensuscruncher_tpu_torch.ops import consensus_vote
from consensuscruncher_tpu_torch.ops.consensus_vote import ConsensusConfig

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "consensuscruncher_tpu_torch", "csrc")

DRIVER = r"""
#include <cstdint>
#include <cstdio>
#include <vector>
#include <algorithm>
#define __device__
#define __host__
#define __forceinline__ inline
static inline int __ffs(unsigned x) { return __builtin_ffs(x); }
using std::max;
using std::min;
static inline uint32_t max(uint32_t a, uint32_t b) { return a > b ? a : b; }
#include "vote_state.cuh"

template <class Tally>
static cct::Vote vote(const std::vector<int>& b, const std::vector<int>& q, int start,
                      int size, int length, int j, int thr, int num, int den, int cap,
                      cct::QcPart* qc) {
  Tally t;
  t.init();
  auto at = [&](int m) { return (start + m) * length + j; };
  for (int m = 0; m < size; ++m) t.fold(b[at(m)], cct::increment(q[at(m)], thr));
  *qc = t.qc();
  return cct::finalize(t, size, num, den, cap, [&](int m) {
    return cct::effective_lane(b[at(m)], cct::increment(q[at(m)], thr));
  });
}

int main() {
  int nf, length, thr, num, den, cap;
  if (scanf("%d %d %d %d %d %d", &nf, &length, &thr, &num, &den, &cap) != 6) return 2;
  std::vector<int> sizes(nf);
  long rows = 0;
  for (int f = 0; f < nf; ++f) {
    if (scanf("%d", &sizes[f]) != 1) return 2;
    rows += sizes[f];
  }
  std::vector<int> b(rows * length), q(rows * length);
  for (auto& x : b) if (scanf("%d", &x) != 1) return 2;
  for (auto& x : q) if (scanf("%d", &x) != 1) return 2;
  int start = 0;
  for (int f = 0; f < nf; ++f) {
    for (int j = 0; j < length; ++j) {
      cct::QcPart vq, wq;
      const cct::Vote v = sizes[f] <= cct::kPackedMax
          ? vote<cct::PackedTally>(b, q, start, sizes[f], length, j, thr, num, den, cap, &vq)
          : vote<cct::WideTally>(b, q, start, sizes[f], length, j, thr, num, den, cap, &vq);
      const cct::Vote w = vote<cct::WideTally>(b, q, start, sizes[f], length, j, thr, num,
                                               den, cap, &wq);
      printf("%d %d %d %d %d %d %d %d\n", v.base, v.qual, w.base, w.qual, vq.votes, vq.top,
             wq.votes, wq.top);
    }
    start += sizes[f];
  }
  return 0;
}
"""

CONFIGS = {
    "default": ConsensusConfig(),
    "c05_q20": ConsensusConfig(cutoff=0.5, qual_threshold=20),
    "c033_q0_cap255": ConsensusConfig(cutoff=1 / 3, qual_threshold=0, qual_cap=255),
    "c0_q30": ConsensusConfig(cutoff=0.0, qual_threshold=30),
    "c1_q10": ConsensusConfig(cutoff=1.0, qual_threshold=10, qual_cap=40),
}


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/vote_state.cuh's driver")
    work = tmp_path_factory.mktemp("vote_state")
    stub = work / "stub"
    stub.mkdir()
    (stub / "cuda_runtime.h").write_text("#pragma once\n")
    (work / "driver.cpp").write_text(DRIVER)
    exe = work / "driver"
    subprocess.run([cxx, "-O1", "-std=c++17", f"-I{stub}", f"-I{CSRC}",
                    str(work / "driver.cpp"), "-o", str(exe)], check=True)
    return str(exe)


def _stream(seed):
    """Families of 0-6, 7-40 and 257-300 members; every third family's
    members split between two lanes (ties); bases A C G T N PAD."""
    rng = np.random.default_rng(seed)
    sizes = np.concatenate([rng.integers(0, 7, 240), rng.integers(7, 41, 50),
                            [257, 300, 256]]).astype(np.int64)
    rng.shuffle(sizes)
    length = 6
    m = int(sizes.sum())
    bases = rng.integers(0, 6, (m, length)).astype(np.uint8)
    quals = rng.integers(0, 61, (m, length)).astype(np.uint8)
    start = 0
    for f, size in enumerate(sizes):
        if f % 3 == 0:
            pair = rng.choice(5, 2, replace=False).astype(np.uint8)
            bases[start:start + size] = pair[rng.integers(0, 2, (size, length))]
        start += size
    return sizes, bases, quals


def _run_driver(driver, config, sizes, bases, quals):
    """Per family and position: the kernels' tally's vote (base, qual),
    WideTally's, and the QC parts (votes, top count) of both."""
    num, den = config.cutoff_rational
    text = " ".join(map(str, [len(sizes), bases.shape[1], config.qual_threshold, num, den,
                              config.qual_cap, *sizes.tolist(), *bases.ravel().tolist(),
                              *quals.ravel().tolist()]))
    run = subprocess.run([driver], input=text, capture_output=True, text=True, check=True)
    return np.array(run.stdout.split(), np.int64).reshape(len(sizes), bases.shape[1], 8)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tally_matches_plain_vote(driver, name):
    config = CONFIGS[name]
    sizes, bases, quals = _stream(sorted(CONFIGS).index(name) + 5)
    got = _run_driver(driver, config, sizes, bases, quals)
    want = consensus_vote.vote_members_plain(torch.from_numpy(bases), torch.from_numpy(quals),
                                             torch.from_numpy(sizes), config).numpy()
    np.testing.assert_array_equal(got[..., 0], want[0])  # the kernels' tally
    np.testing.assert_array_equal(got[..., 1], want[1])
    np.testing.assert_array_equal(got[..., 2], want[0])  # WideTally at every size
    np.testing.assert_array_equal(got[..., 3], want[1])
    # the stream exercised what it is for: passing votes, ties that pass
    assert (want[0] < 4).any() and (want[0] == 4).any()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tally_qc_part_matches_plain_rider(driver, name):
    config = CONFIGS[name]
    sizes, bases, quals = _stream(sorted(CONFIGS).index(name) + 5)
    got = _run_driver(driver, config, sizes, bases, quals)
    length = bases.shape[1]
    np.testing.assert_array_equal(got[..., 4:6], got[..., 6:8])  # both tallies agree
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    b, q = torch.from_numpy(bases), torch.from_numpy(quals)
    for f in range(len(sizes)):  # family by family, every position live
        _planes, qc = consensus_vote.vote_members_plain(
            b, q, torch.from_numpy(sizes[f:f + 1]), config,
            starts=torch.from_numpy(starts[f:f + 1]), qc_lengths=torch.tensor([length]))
        np.testing.assert_array_equal(got[f, :, 4], qc[0].numpy())
        np.testing.assert_array_equal(got[f, :, 4] - got[f, :, 5], qc[1].numpy())
    # the batch's sums under per-family length masks
    lengths = np.random.default_rng(len(sizes)).integers(0, length + 1, len(sizes))
    _planes, qc = consensus_vote.vote_members_plain(b, q, torch.from_numpy(sizes), config,
                                                    qc_lengths=torch.from_numpy(lengths))
    live = np.arange(length)[None, :] < lengths[:, None]
    np.testing.assert_array_equal(np.where(live, got[..., 4], 0).sum(0), qc[0].numpy())
    np.testing.assert_array_equal(np.where(live, got[..., 4] - got[..., 5], 0).sum(0),
                                  qc[1].numpy())
    # failed votes count too: positions whose vote is N still carry votes
    failed = got[..., 0] == 4
    assert failed.any() and (got[..., 4][failed] > 0).any()


def test_tally_qc_part_at_the_packed_limits(driver):
    """Families of kPackedMax (256) members whose every qual is 255, the
    packed lanes' largest sums: the lanes' total must not carry into the
    counts."""
    length = 4
    sizes = np.array([256, 256, 255], np.int64)
    bases = np.zeros((767, length), np.uint8)
    bases[256:512] = np.arange(256)[:, None] % 4  # the second family over A C G T
    bases[512:] = (np.arange(255)[:, None] + np.arange(length)) % 5
    quals = np.full((767, length), 255, np.uint8)
    config = ConsensusConfig(cutoff=0.5, qual_threshold=0, qual_cap=255)
    got = _run_driver(driver, config, sizes, bases, quals)
    assert (got[:2, :, 4] == 256).all() and (got[2, :, 4] == 255).all()
    np.testing.assert_array_equal(got[..., 4:6], got[..., 6:8])  # as the wide tally counts
    assert got[0, :, 5].tolist() == [256] * length and got[1, :, 5].tolist() == [64] * length
