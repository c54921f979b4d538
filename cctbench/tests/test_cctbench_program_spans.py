"""The readers of the program's own spans and counters, on hand-built
summaries and stub cells: each gives its number a command or a step, and
nothing where the program has no such span or counter."""

import sys
import types

import pytest

from cctbench import run, trace, work
from cctbench.trace import Interval

CARD = "NVIDIA H100 80GB HBM3"
PANEL = {"decode_idle_s": "io.decode", "grouping_idle_s": "grouping.block",
         "batching_idle_s": "batching.flush", "encode_idle_s": "vote.encode",
         "vote_call_idle_s": "vote.call", "emit_idle_s": "sscs.emit", "sort_idle_s": "io.sort",
         "deflate_idle_s": "io.deflate"}
MESH = {"step_inputs_idle_ms": "mesh.inputs", "step_checks_idle_ms": "vote.checks",
        "step_plan_idle_ms": "vote.plan", "step_launch_idle_ms": "vote.launch"}
B1 = "void (anonymous namespace)::vote_tiles_kernel<2, false, true>(Params)"
B2 = "void (anonymous namespace)::vote_tiles_kernel<0, true, false>(Params)"


class Cell:
    card_kind = CARD

    def __init__(self, summary, commands=0, steps=0):
        self.summary, self.steps = summary, steps
        self.walls = [{"sscs": 1.0}] * commands


def read(name):
    return run.reader(name)


def program(monkeypatch, doc):
    """The program's CLI as a stub that kept ``doc`` as its last run."""
    cli = types.SimpleNamespace(last_run_metrics=lambda: doc)
    monkeypatch.setitem(sys.modules, "consensuscruncher_tpu_torch.cli", cli)


def summary(spans, device=()):
    return trace.summarize(list(device), spans, 0, 10_000)


@pytest.mark.parametrize("metric,span", sorted(PANEL.items()))
def test_panel_idle_a_command(metric, span):
    s = summary([Interval("sscs", 0, 9000), Interval(span, 1000, 4000)])
    assert read(metric)(Cell(s, commands=3)) == pytest.approx(3000e-9 / 3)
    assert read(metric)(Cell(summary([Interval("sscs", 0, 9000)]), commands=3)) is None
    assert read(metric)(Cell(s, commands=0)) is None


@pytest.mark.parametrize("metric,span", sorted(MESH.items()))
def test_mesh_idle_a_step(metric, span):
    s = summary([Interval("step", 0, 9000), Interval(span, 2000, 2500)],
                [Interval(B2, 6000, 7000)])
    assert read(metric)(Cell(s, steps=5)) == pytest.approx(1e3 * 500e-9 / 5)
    assert read(metric)(Cell(summary([Interval("step", 0, 9000)]), steps=5)) is None
    assert read(metric)(Cell(None, steps=5)) is None


def test_h2d_bytes_is_the_last_runs(monkeypatch):
    cell = Cell(None, commands=2)
    program(monkeypatch, {"bytes_h2d": 123456})
    assert read("h2d_bytes")(cell) == 123456
    assert read("h2d_bytes")(Cell(None, commands=0)) is None
    program(monkeypatch, {"wall_s": 1.0})  # a program that counts no bytes
    assert read("h2d_bytes")(cell) is None
    monkeypatch.setitem(sys.modules, "consensuscruncher_tpu_torch.cli", types.ModuleType("cli"))
    assert read("h2d_bytes")(cell) is None  # a program with no in-memory record


def test_b1_roofline_counts_only_the_sscs_vote(monkeypatch):
    m, o = 4_000_000, 300_000
    program(monkeypatch, {"vote_member_positions": m, "vote_output_positions": o})
    device = [Interval(B1, 0, 2000), Interval(B1, 3000, 4000), Interval(B2, 5000, 9000)]
    cell = Cell(summary([], device), commands=2)
    w = {"bytes": 2 * m + 2 * o, "ops": work.FOLD_OPS * m + work.FINALIZE_OPS * o}
    least = work.least_seconds(w, work.peaks(CARD))[0]
    # 3000 ns of B1 over two commands; B2's 4000 ns are not B1's
    assert read("b1_roofline")(cell) == pytest.approx(100 * least / 1500e-9)
    assert read("b1_roofline")(Cell(summary([], device[2:]), commands=2)) is None
    program(monkeypatch, None)
    assert read("b1_roofline")(cell) is None


def test_b1_is_told_by_the_duplex_argument():
    is_b1 = run.reader("b1_roofline").__globals__["is_b1"]
    assert is_b1(B1) and is_b1("vote_tiles_kernel<0, false, false>")
    assert not is_b1(B2) and not is_b1("vote_tiles_kernel") and not is_b1("elementwise_kernel")
