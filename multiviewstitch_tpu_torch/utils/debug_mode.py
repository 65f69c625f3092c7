"""Numeric stage-boundary checks + elastic stage execution.

PyTorch counterpart of ``multiviewstitch_tpu/utils/debug_mode.py``. The
reference has no sanitizers and fails hard (exit(-1), e.g.
ParamParser.cpp:50, Processor.cpp:798-799).

  - ``check_finite(name, **arrays)``: a stage-boundary assertion on numpy
    arrays or tensors (on any device): one reduction per array and one
    host read. The CLI's ``MVS_DEBUG_NUMERICS=1`` switch runs it at the
    stage boundaries of ``cli.run_align`` (the pose chain's transforms,
    the reconstructed mesh), where the JAX package turns on
    jax_debug_nans / jax_debug_infs inside its jitted stages.
  - ``run_stage(...)``: retries a stage function on transient failures
    (the JAX package's list of device-reset / RPC / allocator signatures)
    with exponential backoff and re-raises real errors. With the stage
    manifest (io/manifest.py), a killed run resumes at the last completed
    stage.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np
import torch

log = logging.getLogger("mvs")

# error signatures considered transient (worth a retry): device resets,
# RPC/tunnel drops, allocator pressure
_TRANSIENT = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED",
              "ABORTED", "preempt", "connection reset", "socket closed")


def check_finite(name: str, **arrays) -> None:
    """Raise FloatingPointError naming the stage and the offending array
    (with its count of non-finite values) if any value is NaN or inf."""
    for k, a in arrays.items():
        t = torch.as_tensor(a) if isinstance(a, np.ndarray) else a
        bad = int((~torch.isfinite(t)).sum())
        if bad:
            raise FloatingPointError(
                f"stage '{name}': array '{k}' has {bad}/{t.numel()} "
                f"non-finite values (shape {tuple(t.shape)})")


def _is_transient(err: BaseException) -> bool:
    s = f"{type(err).__name__}: {err}"
    return any(sig.lower() in s.lower() for sig in _TRANSIENT)


def run_stage(fn: Callable, *args, stage: str = "", retries: int = 2,
              backoff_s: float = 2.0, **kwargs):
    """Run a pipeline stage with retry-on-preemption semantics: transient
    failures are retried up to ``retries`` times with exponential backoff,
    other errors re-raise at once. Stage functions must be idempotent."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - classify then re-raise
            if attempt >= retries or not _is_transient(e):
                raise
            attempt += 1
            wait = backoff_s * (2.0 ** (attempt - 1))
            log.warning("stage %r hit transient failure (%s); retry "
                        "%d/%d in %.1fs", stage or fn.__name__, e,
                        attempt, retries, wait)
            time.sleep(wait)
