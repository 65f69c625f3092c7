"""Profiling helpers: torch.profiler traces and timing of a callable.

PyTorch counterpart of ``multiviewstitch_tpu/utils/profiling.py`` (the
reference's only measurement is a clock() print around PartRecog,
Alignment.cpp:46-52; SURVEY §5.1):

  - ``trace``: a context manager that records the enclosed region with
    torch.profiler (CPU activity, and CUDA activity where a card is
    present) and writes a Chrome trace (``chrome://tracing``, Perfetto).
  - ``device_time``: best-of-reps wall seconds of a call, synchronising
    the card when the result lives on it.
  - ``compiled_flops``: the FLOPs of one call as PyTorch's
    ``FlopCounterMode`` counts them (matmuls, convolutions, attention).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """Record the enclosed region; on exit write ``logdir/trace.json``.
    Yields the profiler (or None when disabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _sync(out):
    """Wait for the card if any tensor in ``out`` lives on it."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "__dataclass_fields__"):
            stack.extend(getattr(x, k) for k in x.__dataclass_fields__)


def device_time(fn: Callable, *args, reps: int = 5,
                warmup: int = 1) -> float:
    """Best-of-``reps`` wall seconds of fn(*args), after ``warmup`` calls;
    each timed call ends when its result is ready on the card."""
    for _ in range(warmup):
        _sync(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def compiled_flops(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one call of fn(*args) by ``FlopCounterMode`` (None where
    this torch has no flop counter)."""
    try:
        from torch.utils.flop_counter import FlopCounterMode
    except ImportError:
        return None
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())
