"""Point-set PCA utilities (PointSetUtils re-design).

PyTorch counterpart of ``multiviewstitch_tpu/solvers/pca.py``: barycenter
and AABB (PointSetUtils.cpp:43-62), CalcPivots — eigenvectors of the 3x3
covariance in descending eigenvalue order (PointSetUtils.cpp:9-41) — the
reference's scale measurement and its normal-equation plane fit.
"""

from __future__ import annotations

import numpy as np
import torch


def barycenter(points, mask=None):
    if mask is None:
        return points.mean(dim=-2)
    m = mask[..., None].to(points.dtype)
    return (points * m).sum(-2) / m.sum(-2).clamp_min(1.0)


def aabb(points, mask=None):
    if mask is None:
        return points.amin(-2), points.amax(-2)
    inf = torch.tensor(float("inf"), dtype=points.dtype, device=points.device)
    lo = torch.where(mask[..., None], points, inf).amin(-2)
    hi = torch.where(mask[..., None], points, -inf).amax(-2)
    return lo, hi


def pivots(points, mask=None):
    """Principal axes as COLUMNS of a 3x3 matrix in descending eigenvalue
    order (CalcPivots, PointSetUtils.cpp:9-41). Returns (P, eigvals,
    center) on the points' device.

    The centre and covariance are reduced on the points' device in
    float64 and rounded to the points' dtype, so the card and the CPU
    hand the same matrix to the eigen solver (their summation orders
    differ); its 3x3 eigh runs on a CPU copy, by the LAPACK routine the
    JAX package's CPU eigh calls.
    Eigenvector signs are arbitrary (as Eigen's are) and callers fix them
    against rays, as the reference does; this way the card, the CPU tests
    and the JAX package agree on them wherever the covariance determines
    them. On a mirror-symmetric point set the off-diagonal sums are
    float32 noise and the signs follow it (solvers/alignment orients the
    template from its stored frame). The JAX caller pulls the same 3x3
    result to the host, so this is a host step of the algorithm, not a
    fallback."""
    p64 = points.double()
    c = barycenter(p64, mask)
    d = p64 - c[..., None, :]
    if mask is not None:
        d = d * mask[..., None].double()
        n = mask.sum(-1).double().clamp_min(1.0)[..., None, None]
    else:
        n = points.shape[-2]
    cov = ((d[..., :, :, None] * d[..., :, None, :]).sum(-3) / n)
    w, v = _eigh_lapack(cov.to(points.dtype).cpu().numpy())   # ascending
    order = np.argsort(-w, axis=-1, kind="stable")
    v = np.take_along_axis(v, order[..., None, :], axis=-1)
    w = np.take_along_axis(w, order, axis=-1)
    return (torch.as_tensor(v, device=points.device),
            torch.as_tensor(w, device=points.device), c.to(points.dtype))


def _eigh_lapack(cov: np.ndarray):
    """Batched 3x3 eigh by LAPACK's ?syevd through scipy, the routine the
    JAX package's CPU eigh calls: the same eigenvectors, signs included,
    for the same matrix (torch.linalg.eigh's LAPACK may flip them)."""
    from scipy.linalg import eigh
    w = np.empty(cov.shape[:-1], cov.dtype)
    v = np.empty_like(cov)
    for i in np.ndindex(cov.shape[:-2]):
        w[i], v[i] = eigh(cov[i], driver="evd")
    return w, v


def extent_along(points, axis_vec, center, mask=None):
    """Signed extent range (min, max) of projections t = axis.(p-c)/|axis|^2,
    the reference's scale measurement (Alignment.cpp:281-296). Returns
    (min, max, t), computed in float64 (one rounding per projection on
    every device)."""
    p = points.double()
    a = axis_vec.to(p)
    t = ((p - center.to(p)[..., None, :]) * a[..., None, :]).sum(-1) \
        / (a * a).sum(-1).clamp_min(1e-12)[..., None]
    if mask is None:
        return t.amin(-1), t.amax(-1), t
    inf = torch.tensor(float("inf"), dtype=p.dtype, device=p.device)
    return (torch.where(mask, t, inf).amin(-1),
            torch.where(mask, t, -inf).amax(-1), t)


def plane_fit(points):
    """LS plane through points [N,3] via the reference's normal-equation form
    (Alignment.cpp:148-161): solve A x = -b with A = sum p p^T, b = sum p
    (in float64); returns (unit normal, d) with plane n.x + d = 0, in the
    points' dtype."""
    p = points.double()
    A = (p[:, :, None] * p[:, None, :]).sum(0)
    ans = -torch.linalg.solve(A, p.sum(0))
    norm = torch.linalg.norm(ans).clamp_min(1e-12)
    return (ans / norm).to(points.dtype), (1.0 / norm).to(points.dtype)
