"""On the card: each cell at a test's size is correct, and its control is
not.  Skips without a card."""

import pytest
import torch

from cctbench.tests.helpers import BENCH, run_small


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_correct_on_the_card_and_control_not(card, cell):
    result = run_small(cell, 2**31 + 77, device="cuda")
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert not run_small(cell, 2**31 + 78, device="cuda", vote="qual_sum_uint8")["correct"]
