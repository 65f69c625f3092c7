"""The port's profiling helpers (utils/profiling.py) on the CPU: a
torch.profiler trace written as a Chrome trace, best-of-reps timing, and
FlopCounterMode's count of a matmul."""

import json
import os

import pytest
import torch

from multiviewstitch_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "t")) as prof:
        (a @ a).sum()
    assert prof is not None
    path = tmp_path / "t" / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profiling.trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not os.path.exists(tmp_path / "off")


def test_device_time_is_the_best_of_reps():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    t = profiling.device_time(fn, torch.ones(8), reps=3, warmup=2)
    assert len(calls) == 5
    assert 0.0 <= t < 1.0


@pytest.mark.parametrize("n", [64, 512])
def test_compiled_flops_counts_a_matmul(n):
    a, b = torch.randn(n, n), torch.randn(n, n)
    assert profiling.compiled_flops(torch.matmul, a, b) == 2.0 * n ** 3
    assert profiling.compiled_flops(torch.add, a, b) == 0.0
