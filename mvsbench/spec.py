"""Finds everything by the names in BENCHMARK.json: a cell's configuration
file, its traffic file (``traffic/<name>.json``), its limits
(``workloads/<cell>.json``), its scene generator (``scenes/<scene>.py``)
and each metric's reader (``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, bench: dict, root: str = ROOT) -> Cell:
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = _json(os.path.join(root, c["file"]))
    traffic = _json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(HERE, "workloads", f"{name}.json"))
    return Cell(name, int(w["chips"]), config, traffic, limits["limits"])


def metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: the end-to-end ones
    untraced, the per-layer ones traced, each where its ``workloads``
    (if any) lists the cell."""
    rows = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in rows if "workloads" not in m
            or cell_name in m["workloads"]]


def reader(name: str):
    """The module ``metrics/<name>.py`` (its ``read(run)``)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"mvsbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scene(name: str):
    return importlib.import_module(f"mvsbench.scenes.{name}")
