"""The reduction of a trace to the busy and idle shares, the breakdown and
the work counts of the B2 roofline, on synthetic events."""

import importlib.util
import os

import numpy as np
import pytest

from cctbench import run, trace, work
from cctbench.trace import Interval


def test_busy_idle_and_named_gaps():
    dev = [Interval("k", 10, 20), Interval("k", 15, 30), Interval("copy", 50, 60),
           Interval("k", 95, 120)]
    spans = [Interval("command", 0, 100), Interval("sscs", 5, 40), Interval("dcs", 45, 80)]
    s = trace.summarize(dev, spans, 0, 100)
    assert s.busy_s == pytest.approx(35e-9) and s.window_s == pytest.approx(100e-9)
    # gaps [0,10) [30,50) [60,95): by the innermost span open over them
    assert s.idle == pytest.approx({"command": 25e-9, "sscs": 15e-9, "dcs": 25e-9})
    b = s.breakdown()
    assert b["device_ops"][0] == ["k", pytest.approx(50e-9)]
    assert [g[0] for g in b["idle_gaps"]] == ["command", "dcs", "sscs"]
    assert s.device_seconds("k") == (pytest.approx(50e-9), 3)


def test_gaps_outside_spans_are_the_harness():
    s = trace.summarize([Interval("k", 40, 60)], [Interval("step", 0, 30)], 0, 100)
    assert s.idle == pytest.approx({"step": 30e-9, "harness": 50e-9})


def read(name):
    return run.reader(name)


class FakeCell:
    card_kind = "NVIDIA H100 80GB HBM3"


def test_duplex_step_work_and_roofline():
    sa, sb = np.array([50, 60, 0]), np.array([55, 0, 70])
    w = work.duplex_step(sa, sb, 100)
    live = 235
    assert w["bytes"] == 2 * live * 100 + 6 * 3 * 100
    assert w["ops"] == 6 * live * 100 + 66 * 3 * 100
    assert work.duplex_work(live, 3, 100) == w
    card = work.peaks(FakeCell.card_kind)
    least, bound = work.least_seconds(w, card)
    by_bytes, by_ops = w["bytes"] / card["hbm_bytes_per_s"], w["ops"] / card["int32_ops_per_s"]
    assert least == pytest.approx(max(by_bytes, by_ops))
    assert bound == ("bytes" if by_bytes >= by_ops else "operations")
    cell = FakeCell()
    cell.step_work = lambda: [w, w]
    cell.summary = trace.summarize([Interval("void vote_tiles_kernel<0, true, false>", 0, 4000)] * 2,
                                   [], 0, 10000)
    assert read("b2_roofline")(cell) == pytest.approx(100 * least / 4e-6)
    # one reader serves every split of the idle share
    assert read("device_idle_pct.mesh")(cell) == pytest.approx(60.0)
    assert read("device_idle_pct.consensus")(cell) == pytest.approx(60.0)
    cell.summary = trace.summarize([], [], 0, 10000)
    assert read("b2_roofline")(cell) is None


def test_every_reader_reports_nothing_without_its_source():
    class Empty:
        walls, launches, vote_s, summary, steps, host_s = [], [], [], None, 0, 0.0
        card_kind = FakeCell.card_kind

        def step_work(self):
            return []

    for m in run.load_json(run.ROOT, "BENCHMARK.json")["per_layer"]:
        assert read(m["name"])(Empty()) is None, m["name"]


def test_reader_files_are_plain_modules():
    for name in os.listdir(os.path.join(run.BENCH_DIR, "metrics")):
        if name.endswith(".py") and name != "__init__.py":
            spec = importlib.util.spec_from_file_location("m", os.path.join(
                run.BENCH_DIR, "metrics", name))
            assert spec is not None
