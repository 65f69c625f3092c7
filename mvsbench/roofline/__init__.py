"""Least times of the port's kernels, from the bytes and operations their
inputs need, against the published peaks of one H100 SXM (NVIDIA's data
sheet, at its full 700 W power limit; the result line states the card's
limit beside them). One module per kernel: ``bound(...)`` gives its least
seconds for one call and ``KERNELS`` the pattern of its device event
names."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def least_seconds(n_bytes: float, flops: float) -> float:
    """The larger of moving ``n_bytes`` at the HBM peak and doing
    ``flops`` float32 operations at the CUDA-core peak."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def existing_neighbours(n: int, offsets) -> list:
    """Per frame, how many of frames f + o (o in offsets) exist."""
    return [sum(1 for o in offsets if 0 <= f + o < n) for f in range(n)]
