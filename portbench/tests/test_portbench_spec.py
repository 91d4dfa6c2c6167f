"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re
from pathlib import Path

import pytest

from portbench import core

BENCH = json.loads((core.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (core.REPO / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    names = [e["name"] for e in METRICS]
    assert len(names) == len(set(names)) and len(CELLS) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)


def test_moves_and_workloads_agree():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", [cell]), f"{m['name']}: {cell} does not report {m['moves']}"
    for cell in CELLS:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2
        assert core.per_layer_metrics(BENCH, cell)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(layer.strip() == layer for layer in layers)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_files(cell):
    spec = core.workload(cell)
    for key in ("config", "traffic", "chips"):
        assert spec[key] == CELLS[cell][key]
    assert (core.HERE / "drivers" / f"{spec['driver']}.py").is_file()
    assert "end_to_end" not in spec  # a cell's rates are BENCHMARK.json's alone
    for m in core.rates(BENCH, cell):
        work, unit_s = core.rate_of(m["unit"])
        assert work and unit_s > 0
    for m in core.per_layer_metrics(BENCH, cell):
        assert callable(core.load_module("metrics", m["name"]).read)


def test_check_fits_the_budget():
    """A full check of 24 cells fits: 2 + 14 x 24 runs at run_seconds + 60 s,
    2 x 90 s a cell to compile and 1200 s spare within 43,200 s."""
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_paths_hold_the_benchmark_alone():
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p and not p.startswith("/")
        assert not p.endswith("_torch")
    assert not (Path(core.REPO) / BENCH["paths"][0] / "pyisingmontecarlo_tpu_torch").exists()
