"""Essential-matrix RANSAC match filter (the reference's experimental
'Parsac' path).

PyTorch counterpart of ``multiviewstitch_tpu/solvers/essential.py``
(Processor::RemoveOutliersParsac, Processor.cpp:271-378, marked "being
tested", Processor.h:39-41): 8-point essential-matrix hypotheses over
normalized camera rays, all of them one batch of 8x9 SVDs, scored by
inlier count or, as the reference does, by the inlier set's covariance
area (sqrt det of the 2-D pixel covariance: the most compact inlier set
wins).

``essential_from_indices`` scores given hypotheses [K,8], so the port is
held to the JAX package on JAX's own draws; ``remove_outliers_essential``
draws them from the port's counter stream (``solvers/srt``: the top 8 of
its draws over the valid mask). E is defined up to sign.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .srt import RansacStream, stream_bits


def _eight_point(y1, y2):
    """E [...,3,3] from 8 normalized correspondences y1, y2 [...,8,3]
    (constraint rows as in Processor.cpp:296-308), rank-2 projected with
    singular values forced to (1, 1, 0) as the reference does."""
    a, b = y1[..., 0], y1[..., 1]
    c, d = y2[..., 0], y2[..., 1]
    Y = torch.stack([c * a, c * b, c, d * a, d * b, d, a, b,
                     torch.ones_like(a)], -1)               # [...,8,9]
    _, _, Vt = torch.linalg.svd(Y, full_matrices=True)
    E = Vt[..., 8, :].reshape(*Y.shape[:-2], 3, 3)
    U, _, Vt2 = torch.linalg.svd(E)
    S = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * S) @ Vt2


def _epipolar_err(E, y1, y2):
    """|y2^T E y1| per match (algebraic error, Processor.cpp:330):
    E [...,3,3], y [M,3] -> [...,M]."""
    return torch.einsum("ni,...ij,nj->...n", y2, E, y1).abs()


def _cov_area(uv, inl):
    """sqrt det of the pixel covariance of the inliers inl [K,M] of
    uv [M,2] -> [K] (the reference's compactness score)."""
    w = inl.to(uv.dtype)
    n = w.sum(-1).clamp_min(1)
    c = (w @ uv) / n[:, None]                               # [K,2]
    dlt = (uv[None] - c[:, None]) * w[..., None]            # [K,M,2]
    C = dlt.transpose(-1, -2) @ dlt / (n - 1).clamp_min(1)[:, None, None]
    return torch.sqrt(torch.linalg.det(C).clamp_min(0.0))


def essential_from_indices(rays1, rays2, uv1, uv2, mask, idx, *,
                           pixel_err: float = 0.3, score: str = "count"
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Score the hypotheses idx [K,8] (indices of valid matches): rays
    [M,3] (x/z, y/z, 1), pixels uv [M,2], mask [M]. ``score="count"``
    keeps the hypothesis with the most inliers (|y2^T E y1| <= pixel_err);
    ``"area"`` the one whose inlier set is most compact in both images
    (argmin of the larger covariance area; fewer than 2 inliers is
    unusable). Returns (new mask, E, mean error over the input mask)."""
    Es = _eight_point(rays1[idx], rays2[idx])               # [K,3,3]
    inl = mask & (_epipolar_err(Es, rays1, rays2) <= pixel_err)   # [K,M]
    if score == "area":
        big = torch.full(inl.shape[:1], float("inf"), dtype=uv1.dtype,
                         device=uv1.device)
        bad = inl.sum(-1) < 2
        a = torch.maximum(torch.where(bad, big, _cov_area(uv1, inl)),
                          torch.where(bad, big, _cov_area(uv2, inl)))
        best = a.argmin()
    elif score == "count":
        best = inl.sum(-1).argmax()
    else:
        raise ValueError(f"score must be 'count' or 'area', got {score!r}")
    E = Es[best]
    err = _epipolar_err(E, rays1, rays2)
    mean_err = torch.where(mask, err, 0.0).sum() / mask.sum().clamp_min(1)
    return mask & (err <= pixel_err), E, mean_err


def remove_outliers_essential(rays1, rays2, uv1, uv2, mask,
                              stream: RansacStream, *, iters: int = 50,
                              pixel_err: float = 0.3, score: str = "count"):
    """The Parsac filter: ``iters`` 8-match hypotheses drawn from
    ``stream`` (one problem: a 0-dim edge id), scored by
    ``essential_from_indices``. Returns (new mask, E, mean error)."""
    bits = stream_bits(stream, 0, iters, mask.shape[-1])
    g = torch.where(mask, bits, torch.full_like(bits, -1))
    idx = torch.topk(g, 8, dim=-1).indices                  # [K,8]
    return essential_from_indices(rays1, rays2, uv1, uv2, mask, idx,
                                  pixel_err=pixel_err, score=score)


def rays_from_pixels(uv, K):
    """Pixels [M,2] -> normalized rays (x/z, y/z, 1) through K^-1 (the
    reference's GetPointCam and divide by z, Processor.cpp:281-285)."""
    x = (uv[:, 0] - K[0, 2]) / K[0, 0]
    y = (uv[:, 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y, torch.ones_like(x)], -1)
