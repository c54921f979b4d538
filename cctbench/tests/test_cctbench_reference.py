"""The plain reference on hand-built cases, and against the program on the
CPU at a small size (the program's plain PyTorch versions)."""

import numpy as np
import torch

from cctbench import reference, simulate
from cctbench.tests.helpers import config, run_small

CONS = {"cutoff": 0.7, "qual_threshold": 0, "qual_cap": 60}
A, C, G, T, N = 0, 1, 2, 3, 4


def vote(members, quals, size=None, cons=CONS, vote_kind="exact"):
    b = torch.tensor([members], dtype=torch.uint8)
    q = torch.tensor([quals], dtype=torch.uint8)
    s = torch.tensor([len(members) if size is None else size])
    vb, vq = reference.vote_dense(b, q, s, cons, vote_kind)
    return vb[0].tolist(), vq[0].tolist()


def test_vote_by_hand():
    # position 0: 3 of 3 agree (qual sum capped); position 1: 2 of 3 fails
    # 7/10; position 2: 3 of 3 agree, sum under the cap
    members = [[A, C, G], [A, C, G], [A, T, G]]
    quals = [[30, 30, 10], [30, 30, 10], [30, 30, 10]]
    assert vote(members, quals) == ([A, N, G], [60, 0, 30])


def test_cutoff_is_an_exact_ratio():
    # 7 of 10 passes 7/10 exactly; 6 of 9 (0.667) does not
    seven = [[A]] * 7 + [[C]] * 3
    assert vote(seven, [[20]] * 10) == ([A], [60])
    assert vote([[A]] * 6 + [[C]] * 3, [[5]] * 9) == ([N], [0])


def test_ties_go_to_the_lane_seen_first_and_quality_threshold():
    cons = dict(CONS, cutoff=0.5, qual_threshold=10)
    assert vote([[C], [A], [A], [C]], [[20]] * 4, cons=cons) == ([C], [40])
    # a member under the threshold votes N: 1 of 2 live votes A at 1/2
    assert vote([[A], [C]], [[20], [5]], cons=cons) == ([A], [20])


def test_dead_slots_and_empty_families():
    assert vote([[A], [C]], [[30], [30]], size=1) == ([A], [30])
    assert vote([[A]], [[30]], size=0) == ([N], [0])


def test_uint8_control_wraps_the_quality_sum():
    members, quals = [[A]] * 7, [[40]] * 7
    assert vote(members, quals) == ([A], [60])
    assert vote(members, quals, vote_kind="qual_sum_uint8") == ([A], [280 % 256])


def test_duplex_vote():
    s1, q1 = np.array([A, C, N, G], np.uint8), np.array([30, 30, 0, 40], np.uint8)
    s2, q2 = np.array([A, G, N, G], np.uint8), np.array([20, 30, 0, 40], np.uint8)
    b, q = reference.duplex_vote(s1, q1, s2, q2, 60)
    assert b.tolist() == [A, N, N, G] and q.tolist() == [50, 0, 0, 60]


def test_duplex_step_matches_the_vote_and_counts_pairs():
    g = torch.Generator().manual_seed(5)
    ba = torch.randint(0, 4, (6, 5, 8), generator=g, dtype=torch.uint8)
    qa = torch.randint(20, 41, (6, 5, 8), generator=g, dtype=torch.uint8)
    sa, sb = np.array([5, 3, 1, 0, 2, 4]), np.array([2, 0, 5, 3, 1, 4])
    planes, stats = reference.duplex_step(ba, qa, sa, ba.flip(0), qa, sb, CONS, block=4)
    va = reference.vote_dense(ba, qa, torch.from_numpy(sa), CONS)
    assert torch.equal(planes[0], va[0]) and torch.equal(planes[1], va[1])
    both = (sa > 0) & (sb > 0)
    assert stats[0] == 6 and stats[1] == both.sum()
    assert (planes[4][torch.from_numpy(~both)] == N).all()


def test_families_rescues_and_pairs_by_hand():
    """Four fragments: a duplex of two families of 3; a duplex whose strand
    B is a singleton (rescued against the SSCS); a duplex of two singletons
    (both rescued); a lone singleton (remaining)."""
    sim = config("cfdna-panel", 4)["simulation"]
    reads = simulate.make_reads(sim, 1)
    # rebuild the reads of four hand-set fragments through the generator's
    # own layout: take its first fragment's shape and override the sizes
    rng_sizes = {(0, 0): 3, (0, 1): 3, (1, 0): 3, (1, 1): 1, (2, 0): 1, (2, 1): 1,
                 (3, 0): 1, (3, 1): 0}
    fam_a = np.array([rng_sizes[(f, 0)] for f in range(4)])
    fam_b = np.array([rng_sizes[(f, 1)] for f in range(4)])

    def sizes(rng, law, n, _calls=[0]):
        _calls[0] += 1
        return fam_a if _calls[0] == 1 else fam_b

    orig = simulate.family_sizes
    simulate.family_sizes = sizes
    try:
        reads = simulate.make_reads(dict(sim, duplex_fraction=1.0), 1)
    finally:
        simulate.family_sizes = orig
    out = reference.consensus_outputs(reads, CONS)
    # families: 8 ends x ... = (3+3+3+1+1+1+1+0 members) x 2 reads
    assert out["stats"]["sscs"] == {"total_reads": 26, "families": 14, "singletons": 8,
                                    "sscs_written": 6}
    assert out["stats"]["singleton"] == {"singletons_total": 8, "rescued_by_sscs": 2,
                                         "rescued_by_singleton": 4, "remaining": 2}
    assert out["stats"]["dcs"]["pairs"] == 6 and out["stats"]["dcs"]["sscs_unpaired"] == 0
    assert len(out["records"]["dcs"]) == 6
    assert len(out["records"]["all_unique_sscs"]) == 14


def test_program_matches_the_reference_on_the_cpu():
    # the command's traffic on both configurations, families of ~3 and of 50+
    for cell, seed, name in (("panel.consensus", 2**31 + 3, None),
                             ("panel.consensus", 11, "cfdna-ultradeep"),
                             ("ultradeep.mesh_step", 2**32 + 5, None)):
        result = run_small(cell, seed, config_name=name)
        assert result["correct"], (cell, name, result["checks"])
        assert result["failed"] == 0 and result["attempted"] >= 1
        assert list(result)[-1] == "checks"


def test_control_comes_out_not_correct():
    """The reference with eight-bit quality sums in the program's place."""
    for cell, name in (("panel.consensus", None), ("panel.consensus", "cfdna-ultradeep"),
                       ("ultradeep.mesh_step", None)):
        result = run_small(cell, 21, vote="qual_sum_uint8", config_name=name)
        assert not result["correct"], (cell, name)
