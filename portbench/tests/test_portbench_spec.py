"""BENCHMARK.json against the benchmark's contract: names, units, the
metrics' cells, and a file for everything a cell names."""

import json
import re

import pytest

from portbench import common

BENCH = common.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def _reports(cell, metric):
    return cell in metric.get("workloads", [w["name"] for w in
                                            BENCH["workloads"]])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_what_its_cells_report(metric):
    moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    assert metric["workloads"]
    for cell in metric["workloads"]:
        assert _reports(cell, moves), (metric["name"], cell)
    common.find("metrics", metric["name"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_enough(cell):
    e2e = [m for m in BENCH["end_to_end"] if _reports(cell["name"], m)]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert any(_reports(cell["name"], m) for m in BENCH["per_layer"])
    assert cell["chips"] == 1
    _, cfg, mix, limits = common.cell(BENCH, cell["name"])
    assert limits and cfg["name"] == cell["config"]
    common.driver(mix["kind"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
