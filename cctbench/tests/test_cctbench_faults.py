"""Each fault a cell can have, planted under the timed path on the CPU,
makes ``correct`` come out false (the run skips only the look for a card).

The faults: an answer altered where it is produced (one base of the SSCS
vote, or of the duplex step's planes); half of a batch left out (the
second half of a vote's families, or of a step's pairs, comes back
unvoted); a step that returns its state unchanged (the duplex step hands
back the result it held from the batch before, or the first result it held
for a batch of that shape).  A cell on one card has no
exchange between cards to leave out.
"""

import pytest

from cctbench.tests.helpers import run_small

N = 4


def altered(planes):
    planes = planes.clone()
    planes[0, 0, 0] = (planes[0, 0, 0] + 1) % 4
    return planes


def half_left_out(planes):
    planes = planes.clone()
    n = planes.shape[1]
    planes[0, n // 2:] = N
    planes[1, n // 2:] = 0
    return planes


@pytest.mark.parametrize("fault", [altered, half_left_out])
@pytest.mark.parametrize("config_name", ["cfdna-panel", "cfdna-ultradeep"])
def test_sscs_vote_fault_is_caught(monkeypatch, config_name, fault):
    from consensuscruncher_tpu_torch.ops import consensus_segment

    vote = consensus_segment.stream_vote

    def faulty(*args, **kwargs):
        out = vote(*args, **kwargs)
        if isinstance(out, tuple):
            return (fault(out[0]), *out[1:])
        return fault(out)

    monkeypatch.setattr(consensus_segment, "stream_vote", faulty)
    result = run_small("panel.consensus", 31, config_name=config_name)
    assert not result["correct"] and result["failed"] >= 1


@pytest.mark.parametrize("fault", ["altered", "half_left_out", "state_unchanged", "memoised"])
def test_duplex_step_fault_is_caught(monkeypatch, fault):
    from consensuscruncher_tpu_torch.ops import consensus_vote

    duplex = consensus_vote.duplex_wire
    held = []

    def faulty(*args, **kwargs):
        planes, stats = duplex(*args, **kwargs)
        if fault == "memoised":
            held.append((planes, stats))
            return held[0]
        if fault == "state_unchanged":
            # hands back what the step held before this batch
            held.append((planes, stats))
            return held[-2] if len(held) > 1 else held[-1]
        if fault == "altered":
            planes = planes.clone()
            planes[4, 0, 0] = (planes[4, 0, 0] + 1) % 4
            return planes, stats
        planes = planes.clone()
        half = planes.shape[1] // 2
        planes[0::2, half:] = N
        planes[1::2, half:] = 0
        return planes, stats

    monkeypatch.setattr(consensus_vote, "duplex_wire", faulty)
    result = run_small("ultradeep.mesh_step", 41)
    assert not result["correct"] and result["failed"] >= 1
    assert result["checks"]["plane_positions_wrong"]["value"] > 0 or \
        result["checks"]["stats_wrong"]["value"] > 0


def test_each_step_is_handed_a_batch_of_its_own(monkeypatch):
    """No two steps of the window see the same batch, so that a step
    serving a result it held for an input seen before would be wrong."""
    from consensuscruncher_tpu_torch.parallel import mesh

    build = mesh.full_pipeline_step
    seen = []

    def recording(*args, **kwargs):
        step = build(*args, **kwargs)

        def run_step(a_a, *rest):
            seen.append((a_a.data_ptr(), a_a.shape[0]))
            return step(a_a, *rest)

        return run_step

    monkeypatch.setattr(mesh, "full_pipeline_step", recording)
    result = run_small("ultradeep.mesh_step", 43)
    assert result["correct"]
    window = seen[1:1 + 64]  # set-up's one step, then the window's (pool_steps 64)
    assert len(window) >= 2 and len(set(window)) == len(window)
