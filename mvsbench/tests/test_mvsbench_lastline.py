"""The result line and the run's exits: the keys a result line carries,
the checks last on both streams, and no result without the cards, without
the port or with jax loaded."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from mvsbench import harness, spec
from test_mvsbench_trace import HOST, K1, K2, _run
from mvsbench import trace as tr

ROOT = spec.ROOT


def _bench():
    return {"end_to_end": [
        {"name": "frames_per_s", "unit": "frames/s"},
        {"name": "setup_s", "unit": "s"},
        {"name": "peak_device_gb", "unit": "GB", "workloads": ["other"]}],
        "per_layer": [{"name": "prep_s", "unit": "s"},
                      {"name": "device_idle_pct", "unit": "%"}]}


@pytest.mark.parametrize("trace", [False, True])
def test_report_keys(monkeypatch, capsys, trace):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    run = _run(tr.summarize(HOST, [tr.Span(K1, 10, 30), tr.Span(K2, 50, 55)])
               if trace else None)
    run.cell = run.cell._replace(limits={"surface_rmse": 0.05})
    line = harness.report(run, _bench(), trace, 1)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert line["correct"] is True and line["attempted"] == 2
    assert line["failed"] == 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["kind"] == "card"
    assert dev["count"] == 1 and dev["memory_peak_bytes"] == 3_000_000_000
    if trace:
        assert set(line["metrics"]) == {"prep_s", "device_idle_pct"}
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        assert len(line["breakdown"]["device_ops"]) <= 10
    else:
        assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
        assert "breakdown" not in line
    assert line["metrics"]["setup_s" if not trace else "prep_s"]["unit"]
    assert line["checks"] == {"surface_rmse": {"value": 0.04,
                                               "limit": 0.05}}
    harness.emit(line)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == line
    assert err.strip().splitlines()[-2].startswith("check surface_rmse")


def test_a_number_over_its_limit_or_a_failed_job_is_not_correct(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    run = _run(None)
    run.cell = run.cell._replace(limits={"surface_rmse": 0.035})
    assert harness.report(run, _bench(), False, 1)["correct"] is False
    run.cell = run.cell._replace(limits={"surface_rmse": 0.05})
    run.jobs[1].ok = False
    line = harness.report(run, _bench(), False, 1)
    assert line["correct"] is False and line["failed"] == 1
    run.jobs[1].ok = True
    run.cell = run.cell._replace(limits={"surface_rmse": 0.05, "x": 1.0})
    line = harness.report(run, _bench(), False, 1)
    assert line["correct"] is False and line["checks"]["x"]["value"] == "inf"


def test_forbidden_modules(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "multiviewstitch_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "multiviewstitch_tpu_torch.x", object())
    assert harness.forbidden_modules() == ["jax", "multiviewstitch_tpu"]


ARGS = ["--workload", "scan_vga.seq2x16", "--seed", str(2 ** 31 + 9),
        "--seconds", "1", "--trace", "0"]
FAKE_CARD = ("import sys, runpy, torch\n"
             "torch.cuda.is_available = lambda: True\n"
             "torch.cuda.device_count = lambda: 1\n"
             "sys.argv = ['mvsbench/run.py'] + sys.argv[1:]\n"
             "runpy.run_path('mvsbench/run.py', run_name='__main__')\n")


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "mvsbench/run.py"] + ARGS,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "is_available" in out.stderr


def test_without_the_port_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "mvsbench"),
                    os.path.join(tmp_path, "mvsbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", FAKE_CARD] + ARGS,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "the port is not beside the benchmark" in out.stderr
