"""Geometry-quality metrics (point-to-surface RMSE, trajectory ATE).

The port's copy of those in ``multiviewstitch_tpu/utils/metrics.py``
(numpy only). The port's spans and counters are in ``utils/profiling.py``.
"""

from __future__ import annotations

import numpy as np


def point_to_surface_rmse(points: np.ndarray, surface_points: np.ndarray,
                          chunk: int = 4096) -> float:
    """RMSE of nearest-surface-sample distances (the BASELINE's
    'stitched-mesh point-to-surface RMSE' metric; surface sampled densely
    enough that vertex distance ~ surface distance)."""
    d = []
    for c in range(0, len(points), chunk):
        blk = points[c:c + chunk]
        d2 = ((blk[:, None, :] - surface_points[None]) ** 2).sum(-1)
        d.append(np.sqrt(d2.min(1)))
    dist = np.concatenate(d) if d else np.zeros(0)
    return float(np.sqrt((dist ** 2).mean())) if len(dist) else 0.0


def trajectory_ate(est_centers: np.ndarray, gt_centers: np.ndarray
                   ) -> float:
    """Absolute trajectory error after similarity (Umeyama) alignment —
    the BASELINE's 'camera trajectory within its ATE bound' metric."""
    mu_e = est_centers.mean(0)
    mu_g = gt_centers.mean(0)
    E = est_centers - mu_e
    G = gt_centers - mu_g
    S = E.T @ G / len(E)
    U, D, Vt = np.linalg.svd(S)
    sgn = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        sgn[2, 2] = -1
    R = (U @ sgn @ Vt).T
    var = (E ** 2).sum() / len(E)
    s = np.trace(np.diag(D) @ sgn) / max(var, 1e-12)
    t = mu_g - s * R @ mu_e
    aligned = (s * (R @ est_centers.T)).T + t
    return float(np.sqrt(((aligned - gt_centers) ** 2).sum(1).mean()))
