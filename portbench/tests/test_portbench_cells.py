"""BENCHMARK.json against the contract, and every name in it found from
its file."""

import json
import os
import re

import pytest

from portbench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cells.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    data = cells.config(cfg["name"])
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"] == []
    assert 1 <= len(cfg["source"]) <= 200 and 1 <= len(cfg["why"]) <= 200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    data = cells.workload(cell["name"])
    for k in ("config", "traffic", "chips", "why"):
        assert data[k] == cell[k]
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert hasattr(cells.driver(data["driver"]), "Driver")
    e2e = cells.end_to_end(BENCH, cell["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert cells.per_layer(BENCH, cell["name"])
    assert set(data["limits"]) and all(v >= 0 for v in data["limits"].values())


def test_metrics_well_formed():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    cell_names = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cell_names)) <= cell_names
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in cells.end_to_end(BENCH, cell)}
        layers.add(m["layer"])
        assert callable(cells.reader(m["name"]))
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
    assert layers <= {"train step", "campaign", "decode entry", "kernels", "device",
                      "whole step"}


def test_every_config_used_and_files_named_from_names():
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for dirpath, _, files in os.walk(os.path.join(cells.ROOT, "portbench")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), cells.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_run_seconds_fits_the_check():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert json.loads(json.dumps(BENCH)) == BENCH
