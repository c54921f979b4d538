"""BENCHMARK.json against the benchmark's contract, and every part found by
its name: configurations, traffic mixes, drivers and per-layer readers."""

import importlib
import json
import os
import re

import pytest

from cctbench import run
from cctbench.tests.helpers import BENCH

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cctbench"] and BENCH["command"][1] == "cctbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lengths():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and not set(entry[key]) & {"\n", "\t"}
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in BENCH[group]]
        assert len(group_names) == len(set(group_names))


def test_configs_found_by_name():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"cctbench/configs/{c['name']}.json"
        held = run.load_json(run.ROOT, c["file"])
        assert held["name"] == c["name"] and held["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(run.ROOT, held["reference"]))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_traffic_and_drivers_found_by_name():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        traffic = run.load_json(run.BENCH_DIR, "traffic", f"{w['traffic']}.json")
        driver = importlib.import_module(f"cctbench.drivers.{traffic['driver']}")
        assert hasattr(driver.Cell, "window") and hasattr(driver.Cell, "check")
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])


def test_metrics_and_readers_found_by_name():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert callable(run.reader(m["name"]))
        # a cell that lists the metric reports the end-to-end metric it moves
        assert all(run.applies(e2e[m["moves"]], c) for c in m["workloads"])
    for cell in cells:
        own = [m for m in BENCH["end_to_end"] if run.applies(m, cell)]
        assert len(own) >= 2 and any(run.applies(m, cell) for m in BENCH["per_layer"])


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        run.find(BENCH["workloads"], "no.such.cell", "workload")
    assert json.dumps(BENCH)
