"""Variational depth-map refinement (the feature DepthRecovery never shipped).

PyTorch counterpart of ``multiviewstitch_tpu/ops/depth_refine.py``. The
reference's DepthOptimizer (DepthOptimizer.h:21-28) loads the
model-rendered depths and never implements its core; this completes it as
one batched variational solve over [N,H,W]:

  min_d  sum w_meas (d - d_meas)^2 + lam_model sum w_mod (d - d_model)^2
         + lam_smooth sum w_edge |grad d|^2

by Jacobi-preconditioned CG with a 4-neighbour stencil. The stencil adds
shifted slices in place (no padded copies), and every CG scalar stays a
device tensor, so the iterations run with no host read.
"""

from __future__ import annotations

import torch


def _grad_energy_matvec(d, lam_s, wx, wy):
    """lam_s * div(w grad d): the JAX package's four padded shifts
    ((A - B) + C) - D, as in-place adds of shifted slices."""
    dx = (d[:, :, 1:] - d[:, :, :-1]) * wx
    dy = (d[:, 1:, :] - d[:, :-1, :]) * wy
    out = torch.zeros_like(d)
    out[:, :, 1:] += dx
    out[:, :, :-1] -= dx
    out[:, 1:, :] += dy
    out[:, :-1, :] -= dy
    return lam_s * out


def refine_depth(d_meas, d_model, *, lam_model: float = 0.5,
                 lam_smooth: float = 0.2, iters: int = 100,
                 edge_aware: bool = True):
    """Fuse measured [N,H,W] (0 = invalid) and model-rendered [N,H,W]
    (0 = none) disparity under a smoothness prior; ``iters`` CG iterations
    over the whole batch. Pixels invalid in both sources stay 0."""
    w_meas = (d_meas > 0).to(d_meas.dtype)
    w_mod = lam_model * (d_model > 0).to(d_meas.dtype)
    w_obs = w_meas + w_mod
    guide = torch.where(d_meas > 0, d_meas, d_model)
    if edge_aware:
        gx = (guide[:, :, 1:] - guide[:, :, :-1]).abs()
        gy = (guide[:, 1:, :] - guide[:, :-1, :]).abs()
        mean_gx = torch.where(gx > 0, gx, torch.zeros_like(gx)).mean()
        scale = 10.0 / (mean_gx + 1e-6).clamp_min(1e-6)
        wx = torch.exp(-gx * scale)
        wy = torch.exp(-gy * scale)
    else:
        wx = torch.ones_like(guide[:, :, 1:])
        wy = torch.ones_like(guide[:, 1:, :])

    b = w_meas * d_meas + w_mod * d_model

    def matvec(x):
        return w_obs * x + _grad_energy_matvec(x, lam_smooth, wx, wy)

    diag = (w_obs + lam_smooth * 4.0).clamp_min(1e-9)
    x = guide
    r = b - matvec(x)
    z = r / diag
    p = z
    rz = (r * z).sum()
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rz / (p * Ap).sum().clamp_min(1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r / diag
        rz_new = (r * z).sum()
        p = z + (rz_new / rz.clamp_min(1e-20)) * p
        rz = rz_new
    return torch.where(w_obs > 0, x, torch.zeros_like(x))
