"""On the card (marker ``gpu``; each test skips without one): every cell
runs and comes out correct, and at the cell's own size the TF32 control
fails the committed limits that the sound job keeps.

    python -m pytest mvsbench/tests -q -m gpu
"""

import json
import math
import subprocess
import sys

import pytest
import torch

from mvsbench import calibrate, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(name):
    _card()
    out = subprocess.run(
        [sys.executable, "mvsbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 101), "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in
                                    spec.metrics(BENCH, name, False)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    _card()
    cell = spec.cell(name, BENCH)
    r = calibrate.readings(cell, 2 ** 31 + 103, torch.device("cuda"))
    lim = cell.limits
    assert all(v <= lim.get(k, -math.inf) for k, v in r["sound"].items())
    assert any(v > lim.get(k, math.inf) for k, v in r["control"].items())
