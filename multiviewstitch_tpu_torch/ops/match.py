"""Descriptor matching: one batched GEMM plus a top-2 ratio test.

PyTorch counterpart of ``multiviewstitch_tpu/ops/match.py`` (SiftMatchGPU's
acceptance rule, FeatureProc.cpp:83-90): best-match distance <= distmax
and Lowe ratio <= ratiomax. Descriptors are L2-normalised, so squared
distance = 2 - 2*dot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Matches(NamedTuple):
    idx1: torch.Tensor   # [...,M] indices into set 1
    idx2: torch.Tensor   # [...,M] indices into set 2
    valid: torch.Tensor  # [...,M] bool


def match_descriptors(d1, v1, d2, v2, *, distmax: float = 0.7,
                      ratiomax: float = 0.8) -> Matches:
    """One candidate per set-1 keypoint. d1 [...,K1,128], v1 [...,K1],
    d2 [...,K2,128], v2 [...,K2] (leading dims batch)."""
    dots = torch.matmul(d1, d2.transpose(-1, -2))
    dots = torch.where(v1[..., :, None] & v2[..., None, :], dots,
                       torch.full_like(dots, -1.0))
    top2, top2_idx = torch.topk(dots, 2, dim=-1)
    best = top2[..., 0]
    second = top2[..., 1]
    dist_best = torch.sqrt((2.0 - 2.0 * best).clamp_min(0.0))
    dist_second = torch.sqrt((2.0 - 2.0 * second).clamp_min(0.0))
    ok = (best > -1.0) & (dist_best <= distmax)
    ok = ok & (dist_best <= ratiomax * dist_second)
    rows = torch.arange(d1.shape[-2], device=d1.device).expand(best.shape)
    ok = ok & v1
    return Matches(rows, top2_idx[..., 0], ok)
