"""Bundle adjustment: damped Gauss-Newton (LM) with Schur-complement
reduction.

PyTorch counterpart of ``multiviewstitch_tpu/solvers/ba.py``. The
reference has no BA: its poses are a greedy per-pair RANSAC SRT chain
(Processor.cpp:813-826); ``pipeline/ba_refine`` refines that chain with
this solver.

Formulation (textbook BA):
  - cameras: axis-angle rotation + translation (6 dof each), one shared K
  - points: free 3D positions
  - residuals: pinhole reprojection errors, one [O] batch
  - Jacobians in closed form (``projection_jacobians``)
  - normal equations in the per-point grouped [P,M] layout that
    ``make_problem`` builds on the host: the point blocks H_pp [P,3,3]
    invert in closed form; the camera-indexed sums (H_cc, b_c and the
    per-(point, camera) blocks of the Schur cross term) are ``index_add_``
    over each slot's camera id, where the JAX package multiplies by one-hot
    [P,M,C] matrices; the cross term S = H_cc - sum_p (W Hpp^-1)(p) W(p)^T
    is one [6C, 3P] @ [3P, 6C] matmul; the reduced 6C x 6C system solves
    dense (LU).
  - the LM loop runs ``iters`` iterations with accept / reject by
    ``torch.where`` and no host read; once the damping reaches 1e3 (where
    the JAX loop exits) the state stays frozen.

Everything is float32 with matmuls at full float32 precision (torch's
default: TF32 stays off). ``make_problem`` sizes the grouped layout to the
true per-point maximum so the gradient is exact, and warns when an
explicit smaller cap drops observations; ``apply_mask`` masks
observations consistently in both layouts.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.profiling import count

def _skew(v):
    """[...,3] -> [...,3,3] cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def rodrigues(rvec):
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (exp map):
    R = I + A(θ²) K + B(θ²) K², A = sinθ/θ, B = (1-cosθ)/θ², with K the
    unnormalised skew matrix and a series below θ² = 1e-10, so no ||r||
    sits in a denominator and the derivative at r = 0 is finite."""
    K = _skew(rvec)
    t2 = (rvec * rvec).sum(-1)[..., None, None]
    small = t2 < 1e-10
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + A * K + B * (K @ K)


class BAProblem(NamedTuple):
    K: torch.Tensor            # [3,3] shared intrinsics
    cam_idx: torch.Tensor      # [O] int64
    pt_idx: torch.Tensor       # [O] int64
    uv: torch.Tensor           # [O,2] observed pixels
    mask: torch.Tensor         # [O] bool
    # per-point padded observation lists (the grouped layout):
    pt_obs: torch.Tensor       # [P,M] int64 indices into the obs arrays
    pt_obs_mask: torch.Tensor  # [P,M] bool
    fixed_cams: torch.Tensor   # [C] bool: gauge fixing (e.g. camera 0)
    cam_of: torch.Tensor       # [P,M] int64 camera of each obs slot
    uv_g: torch.Tensor         # [P,M,2] observed pixels per slot


class BAState(NamedTuple):
    rvec: torch.Tensor         # [C,3]
    tvec: torch.Tensor         # [C,3]
    points: torch.Tensor       # [P,3]


def _group_ranks(group_of: np.ndarray, capacity: int):
    """For each element of a stable sort by ``group_of``: its rank within
    its group and a mask of ranks below ``capacity``."""
    order = np.argsort(group_of, kind="stable")
    gs = np.asarray(group_of)[order]
    n = len(gs)
    starts = np.zeros(n, np.int64)
    if n:
        firsts = np.r_[0, np.flatnonzero(gs[1:] != gs[:-1]) + 1]
        starts[firsts] = firsts
        starts = np.maximum.accumulate(starts)
    rank = (np.arange(n) - starts).astype(np.int32)
    return rank, rank < capacity


def make_problem(K, cam_idx, pt_idx, uv, n_points, max_obs_per_point=None,
                 fixed_cams=None, n_cams=None, *, device) -> BAProblem:
    """Host-side (numpy) assembly of the static problem structure, moved
    to ``device``.

    ``max_obs_per_point=None`` sizes the grouped layout to the true
    per-point maximum so no observation is dropped; an explicit smaller cap
    warns with the number it drops. ``fixed_cams`` (default camera 0) pins
    the gauge."""
    cam_idx = np.asarray(cam_idx, np.int32)
    pt_idx = np.asarray(pt_idx, np.int32)
    uv = np.asarray(uv, np.float32)
    O = len(cam_idx)
    counts = np.bincount(pt_idx, minlength=n_points) if O else \
        np.zeros(n_points, np.int64)
    true_max = max(int(counts.max(initial=0)), 1)
    if max_obs_per_point is None:
        max_obs_per_point = true_max
    elif max_obs_per_point < true_max:
        dropped = int(np.maximum(counts - max_obs_per_point, 0).sum())
        warnings.warn(
            f"make_problem: max_obs_per_point={max_obs_per_point} drops "
            f"{dropped} of {O} observations from the normal equations "
            f"(true per-point max {true_max}); the optimum will be biased "
            "on over-observed tracks", stacklevel=2)
    pt_obs = np.zeros((n_points, max_obs_per_point), np.int32)
    pt_obs_mask = np.zeros((n_points, max_obs_per_point), bool)
    # group by point with a per-group capacity: a stable sort keeps the
    # observation order within each point
    slot, keep = _group_ranks(pt_idx, max_obs_per_point)
    obs_ids = np.argsort(pt_idx, kind="stable").astype(np.int32)
    sel = obs_ids[keep]
    pt_obs[pt_idx[sel], slot[keep]] = sel
    pt_obs_mask[pt_idx[sel], slot[keep]] = True
    cam_of = np.zeros((n_points, max_obs_per_point), np.int32)
    uv_g = np.zeros((n_points, max_obs_per_point, 2), np.float32)
    cam_of[pt_idx[sel], slot[keep]] = cam_idx[sel]
    uv_g[pt_idx[sel], slot[keep]] = uv[sel]
    C = n_cams or int(cam_idx.max()) + 1
    fc = np.zeros(C, bool)
    if fixed_cams is None:
        fc[0] = True
    else:
        fc[np.asarray(fixed_cams)] = True

    def dev(a, dtype=None):
        return torch.as_tensor(a if dtype is None else a.astype(dtype),
                               device=device)
    return BAProblem(dev(np.asarray(K, np.float32)), dev(cam_idx, np.int64),
                     dev(pt_idx, np.int64), dev(uv),
                     torch.ones(O, dtype=torch.bool, device=device),
                     dev(pt_obs, np.int64), dev(pt_obs_mask), dev(fc),
                     dev(cam_of, np.int64), dev(uv_g))


def apply_mask(prob: BAProblem, keep) -> BAProblem:
    """Disable observations where ``keep`` [O] is False in both the flat
    mask (residuals, reprojection_rmse) and the grouped pt_obs_mask
    (gn_step's assembly), so the optimizer and the LM accept test see the
    same observation set."""
    keep = torch.as_tensor(keep, dtype=torch.bool, device=prob.mask.device)
    new_mask = prob.mask & keep
    grouped = prob.pt_obs_mask & new_mask[prob.pt_obs]
    return prob._replace(mask=new_mask, pt_obs_mask=grouped)


def _project(K, R, tvec, X):
    """Camera-frame points and pixel coordinates of X [...,3] through
    rotations R [...,3,3] and translations tvec [...,3] (|z| < 1e-9 is
    taken as 1e-9)."""
    pc = torch.einsum("...ij,...j->...i", R, X) + tvec
    z = pc[..., 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = K[0, 0] * pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    return pc, z, u, v


def residuals(prob: BAProblem, st: BAState):
    """[O,2] reprojection residuals, zero where masked."""
    R = rodrigues(st.rvec)
    _, _, u, v = _project(prob.K, R[prob.cam_idx], st.tvec[prob.cam_idx],
                          st.points[prob.pt_idx])
    r = torch.stack([u - prob.uv[:, 0], v - prob.uv[:, 1]], -1)
    return torch.where(prob.mask[:, None], r, torch.zeros_like(r))


def reprojection_rmse(prob: BAProblem, st: BAState) -> torch.Tensor:
    """RMSE over the masked observations' residual components (a 0-dim
    tensor on the problem's device)."""
    r = residuals(prob, st)
    n = prob.mask.sum().clamp_min(1)
    return torch.sqrt((r ** 2).sum() / (2 * n))


def _so3_right_jacobian(w):
    """Right Jacobian of the exponential map: R(w + dw) ~= R(w) exp([Jr dw])
    (Taylor-guarded at small angles). [...,3] -> [...,3,3]."""
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2.clamp_min(1e-24))
    Kw = _skew(w)
    K2 = Kw @ Kw
    small = th < 1e-4
    a = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th)) / th2.clamp_min(1e-24))
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (th2 * th).clamp_min(1e-24))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand_as(Kw)
    return eye - a[..., None, None] * Kw + b[..., None, None] * K2


def _jacobians(K, R, Jr, tvec, X, uv):
    """Residual and Jacobians through precomputed R = rodrigues(rvec) and
    Jr = _so3_right_jacobian(rvec): see ``projection_jacobians``."""
    pc, z, u, v = _project(K, R, tvec, X)
    r = torch.stack([u - uv[..., 0], v - uv[..., 1]], -1)
    fx, fy = K[0, 0], K[1, 1]
    iz = 1.0 / z
    zero = torch.zeros_like(iz)
    Jpc = torch.stack([
        torch.stack([fx * iz, zero, -fx * pc[..., 0] * iz * iz], -1),
        torch.stack([zero, fy * iz, -fy * pc[..., 1] * iz * iz], -1)],
        -2)                                            # [.,2,3]
    Jp = Jpc @ R                                       # [.,2,3]
    Jw = -(Jp @ _skew(X)) @ Jr                         # [.,2,3]
    return r, torch.cat([Jw, Jpc], -1), Jp


def projection_jacobians(K, rvec, tvec, X, uv):
    """Batched closed-form residual and Jacobians of the reprojection
    residual: r [.,2], Jc = dr/d(rvec,tvec) [.,2,6], Jp = dr/dX [.,2,3]:
      dr/dpc = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]
      dpc/dt = I,  dpc/dX = R,  dpc/drvec = -R [X]x Jr(rvec)."""
    return _jacobians(K, rodrigues(rvec), _so3_right_jacobian(rvec), tvec,
                      X, uv)


def inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / det), elementwise; used
    for the damped SPD point blocks (det > 0 by construction)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    tiny = torch.where(det < 0, torch.full_like(det, -1e-30),
                       torch.full_like(det, 1e-30))
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, tiny, det)
    adj = torch.stack([
        torch.stack([A00, A01, A02], -1),
        torch.stack([A10, A11, A12], -1),
        torch.stack([A20, A21, A22], -1)], -2)
    return adj * inv_det[..., None, None]


def _grouped_schur_terms(K, rvec, tvec, points, cam_of, uv, mask, lam):
    """Schur-complement terms in the per-point grouped layout: points
    [P,3] with observation slots cam_of / uv / mask [P,M,·].

    Returns (S [6C,6C]: minus the cross term, undamped H_cc on its
    diagonal blocks; b [6C]: the reduced right-hand side; Hpp_inv [P,3,3];
    W [P,M,6,3]; bp [P,3])."""
    C = rvec.shape[0]
    P, M = cam_of.shape
    dt, dev = points.dtype, points.device
    R, Jr = rodrigues(rvec), _so3_right_jacobian(rvec)
    r, Jc, Jp = _jacobians(K, R[cam_of], Jr[cam_of], tvec[cam_of],
                           points[:, None, :].expand(P, M, 3), uv)
    r = torch.where(mask[..., None], r, torch.zeros_like(r))
    Jc = torch.where(mask[..., None, None], Jc, torch.zeros_like(Jc))
    Jp = torch.where(mask[..., None, None], Jp, torch.zeros_like(Jp))

    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hpp_inv = inv3x3(torch.einsum("pmai,pmaj->pij", Jp, Jp) + lam * eye3)
    bp = -torch.einsum("pmai,pma->pi", Jp, r)
    W = torch.einsum("pmai,pmaj->pmij", Jc, Jp)            # [P,M,6,3]
    Y = torch.einsum("pmij,pjk->pmik", W, Hpp_inv)         # [P,M,6,3]

    cam = cam_of.reshape(-1)
    Hcc = torch.zeros(C, 6, 6, dtype=dt, device=dev).index_add_(
        0, cam, torch.einsum("pmai,pmaj->pmij", Jc, Jc).reshape(-1, 6, 6))
    bc = torch.zeros(C, 6, dtype=dt, device=dev).index_add_(
        0, cam, -torch.einsum("pmai,pma->pmi", Jc, r).reshape(-1, 6))

    # cross term: sum Y and W per (point, camera), then one matmul
    #   S_cross[c,d] = sum_p G_y[p,c] G_w[p,d]^T
    pc_slot = (torch.arange(P, device=dev)[:, None] * C + cam_of).reshape(-1)

    def per_point_camera(X):                               # -> [6C, 3P]
        G = torch.zeros(P * C, 6, 3, dtype=dt, device=dev).index_add_(
            0, pc_slot, X.reshape(-1, 6, 3))
        return G.view(P, C, 6, 3).permute(1, 2, 0, 3).reshape(6 * C, 3 * P)
    Ay = per_point_camera(Y)
    S = -(Ay @ per_point_camera(W).T)
    blocks = torch.arange(C, device=dev)
    S.view(C, 6, C, 6)[blocks, :, blocks, :] += Hcc
    b = bc.reshape(-1) - Ay @ bp.reshape(-1)
    return S, b, Hpp_inv, W, bp


def back_substitute_points(W, Hpp_inv, bp, cam_of, delta_c):
    """dp = Hpp^-1 (bp - sum_{obs} W^T dc)."""
    WTdc = torch.einsum("pmik,pmi->pmk", W, delta_c[cam_of])
    return torch.einsum("pij,pj->pi", Hpp_inv, bp - WTdc.sum(1))


def solve_reduced(S, b, lam, fixed_cams):
    """The camera step [C,6] of the reduced system S [6C,6C] (undamped;
    updated in place), b [6C]: LM damping ``lam`` on the diagonal, the
    fixed cameras' rows and columns replaced by identity, dense solve."""
    C = fixed_cams.shape[0]
    diag = torch.arange(6 * C, device=S.device)
    S[diag, diag] += lam                   # LM damping of the camera blocks
    # gauge fixing: zero the fixed cameras' rows and columns, identity
    # diagonal
    free = (~fixed_cams).to(S.dtype).repeat_interleave(6)
    S = S * free[:, None] * free[None, :]
    S[diag, diag] += 1.0 - free
    S[diag, diag] += 1e-9
    delta_c = torch.linalg.solve_ex(S, b * free)[0] * free
    return delta_c.reshape(C, 6)


def gn_step(prob: BAProblem, st: BAState, lam) -> Tuple[BAState,
                                                       torch.Tensor]:
    """One damped GN step via the Schur complement. Returns (new state,
    step norm). No host read."""
    S, b, Hpp_inv, W, bp = _grouped_schur_terms(
        prob.K, st.rvec, st.tvec, st.points, prob.cam_of, prob.uv_g,
        prob.pt_obs_mask, lam)
    delta_c = solve_reduced(S, b, lam, prob.fixed_cams)
    delta_p = back_substitute_points(W, Hpp_inv, bp, prob.cam_of, delta_c)
    new = BAState(st.rvec + delta_c[:, :3], st.tvec + delta_c[:, 3:],
                  st.points + delta_p)
    return new, torch.sqrt((delta_c ** 2).sum() + (delta_p ** 2).sum())


def lm_update(step, rmse, st: BAState, best, lam):
    """One LM iteration on device tensors: the candidate ``step(st, lam)``,
    accepted only if its ``rmse(state)`` lowers the RMSE ``best`` (damping
    ``lam`` halved, floor 1e-7) or rejected (damping x4, cap 1e3); once the
    damping is at the cap nothing changes, as the JAX loop exits there.
    Accept / reject are ``torch.where``: no host read. The step and the
    RMSE are the layout's (``lm_step``; the point-sharded solver's in
    ``parallel/ba_dist``). Returns (state, best, lam)."""
    active = lam < 1e3
    cand = step(st, lam)
    err = rmse(cand)
    acc = active & (err < best)
    st = BAState(*(torch.where(acc, c, s) for c, s in zip(cand, st)))
    best = torch.where(acc, err, best)
    lam = torch.where(active, torch.where(acc, (lam * 0.5).clamp_min(1e-7),
                                          (lam * 4.0).clamp_max(1e3)), lam)
    return st, best, lam


def lm_solve(step, rmse, st: BAState, *, iters: int, lam0: float):
    """``iters`` ``lm_update`` iterations from damping ``lam0``, with no
    host read. Returns (state, RMSE as a 0-dim tensor, the number of
    accepted iterations as a 0-dim int32 tensor: the RMSE falls only when
    a step is accepted)."""
    best = rmse(st)
    lam = torch.full((), lam0, dtype=torch.float32, device=best.device)
    accepted = torch.zeros((), dtype=torch.int32, device=best.device)
    for _ in range(iters):
        prev = best
        st, best, lam = lm_update(step, rmse, st, best, lam)
        accepted = accepted + (best < prev).to(torch.int32)
    return st, best, accepted


def _lm_hooks(prob: BAProblem):
    """(step, rmse) of the single-device solver for ``lm_update``."""
    return (lambda st, lam: gn_step(prob, st, lam)[0],
            lambda st: reprojection_rmse(prob, st))


def lm_step(prob: BAProblem, st: BAState, best, lam):
    """One ``lm_update`` of the single-device solver (``gn_step``,
    ``reprojection_rmse``). Returns (state, best, lam)."""
    return lm_update(*_lm_hooks(prob), st, best, lam)


def solve_ba(prob: BAProblem, st: BAState, *, iters: int = 20,
             lam0: float = 1e-3, verbose: bool = False
             ) -> Tuple[BAState, float]:
    """LM solve: ``iters`` ``lm_step`` iterations from damping ``lam0``;
    the single host read is the final RMSE, with the count of accepted
    iterations beside it (counters ``ba.lm_iterations``,
    ``ba.lm_accepted``). Returns (state, RMSE in pixels)."""
    st, best, accepted = lm_solve(*_lm_hooks(prob), st, iters=iters,
                                  lam0=lam0)
    rmse, n_acc = torch.stack([best, accepted.to(best.dtype)]).tolist()
    count("ba.lm_iterations", iters)
    count("ba.lm_accepted", int(n_acc))
    if verbose:
        print(f"  BA: rmse {rmse:.4f} after <= {iters} LM iters")
    return st, rmse
