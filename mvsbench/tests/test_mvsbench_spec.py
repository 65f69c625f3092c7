"""BENCHMARK.json against the rules of its format, and discovery of every
configuration, cell, scene and metric reader by name."""

import json
import os
import re

import pytest

from mvsbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mvsbench"]
    assert BENCH["command"] == ["python3", "mvsbench/run.py"]
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < \
        64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] +
                         METRICS, ids=lambda e: e["name"])
def test_names_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entries(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert hasattr(spec.reader(m["name"]), "read")


@pytest.mark.parametrize("name", CELLS)
def test_cell_discovery(name):
    cell = spec.cell(name, BENCH)
    assert cell.chips in (1, 4)
    assert hasattr(spec.scene(cell.traffic["scene"]), "generate")
    assert cell.config["command"][0] in ("align", "pipeline")
    e2e = [m["name"] for m in spec.metrics(BENCH, name, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics(BENCH, name, True)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("mvsbench/configs/")
    with open(os.path.join(spec.ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell", BENCH)
