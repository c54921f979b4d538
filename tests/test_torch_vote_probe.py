"""The vote kernels' probe (``utils/vote_probe.py``) on the CPU: its seeded
inputs are valid wire batches of the shapes it names, and it refuses to run
without a card."""

import numpy as np
import pytest
import torch

from consensuscruncher_tpu_torch.ops import consensus_vote
from consensuscruncher_tpu_torch.utils import vote_probe


def test_probe_inputs_are_wire_batches_the_wrappers_take():
    rng = np.random.default_rng(0)
    cpu = torch.device("cpu")
    a, book, sizes, m = vote_probe.sscs_case(rng, 300, cpu)
    assert a.shape == (m, 96) and book.numel() == 16 and int(sizes.min()) >= 2
    assert consensus_vote.vote_wire("pack6", a, book, sizes, length=104).shape == (2, 300, 104)
    a, book, sizes, m = vote_probe.duplex_case(rng, 64, cpu)
    assert a.shape == (m, 64) and book.numel() == 4 and sizes.shape == (128,)
    assert int(sizes[64::16].max()) == 0  # every 16th strand-B slot empty
    planes, stats = consensus_vote.duplex_wire("pack4", a, book, sizes, length=128,
                                               packed_out=True)
    assert planes.shape == (3, 64, 128) and int(stats[0]) == 64


def test_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        vote_probe.main()
