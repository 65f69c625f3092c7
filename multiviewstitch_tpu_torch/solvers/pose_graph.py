"""Global similarity pose-graph refinement over the sequence view graph.

PyTorch counterpart of ``multiviewstitch_tpu/solvers/pose_graph.py``. The
reference chains sequences greedily: one keyframe pair per consecutive
sequence pair decides each transform (Processor.cpp:746-826), and every
other surviving match is discarded. This solver optimizes all
per-sequence similarities {s_k, R_k, t_k} (last sequence gauge-fixed to
the identity) against all inlier matches of all sequence pairs:

    min Σ_pairs(k,l) Σ_i  | T_k(p_i) - T_l(q_i) |²

Parametrization: (log s, axis-angle r, t) per sequence, 7 dof each, so the
problem has a few dozen parameters: a dense damped GN from the greedy
chain, with the stacked residual's Jacobian in closed form (the JAX
package takes jax.jacfwd of it):
    d/d log s_k = s_k R_k p,   d/d r_k = -s_k R_k [p]x Jr(r_k),
    d/d t_k = I,               and the negatives for sequence l.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .ba import _skew, _so3_right_jacobian, rodrigues
from ..core.transforms import Similarity


class PoseGraphData(NamedTuple):
    seq_k: torch.Tensor   # [E] int64 first-sequence index per match block
    seq_l: torch.Tensor   # [E] int64 second-sequence index
    p: torch.Tensor       # [E,M,3] points in sequence k's frame (padded)
    q: torch.Tensor       # [E,M,3] matched points in sequence l's frame
    mask: torch.Tensor    # [E,M] bool


def build_data(pairs: List[Tuple[int, int, np.ndarray, np.ndarray,
                                 np.ndarray]],
               max_matches: int = 2048, *, device) -> PoseGraphData:
    """pairs: list of (k, l, p [M,3], q [M,3], mask [M]), each padded or
    cut to ``max_matches``, on ``device``."""
    E = len(pairs)
    sk = np.zeros(E, np.int64)
    sl = np.zeros(E, np.int64)
    P = np.zeros((E, max_matches, 3), np.float32)
    Q = np.zeros((E, max_matches, 3), np.float32)
    Mk = np.zeros((E, max_matches), bool)
    for e, (k, l, p, q, m) in enumerate(pairs):
        n = min(len(p), max_matches)
        sk[e], sl[e] = k, l
        P[e, :n] = p[:n]
        Q[e, :n] = q[:n]
        Mk[e, :n] = m[:n]
    return PoseGraphData(*(torch.as_tensor(a, device=device)
                           for a in (sk, sl, P, Q, Mk)))


def _params_to_sim(params):
    """params [S,7] = (log s, rvec, t) -> (s [S], R [S,3,3], t [S,3])."""
    return torch.exp(params[:, 0]), rodrigues(params[:, 1:4]), params[:, 4:7]


def _weights(r, data: PoseGraphData, delta=None):
    """[E,M] per-match factor: the mask and, with ``delta``, the sqrt-Huber
    IRLS weight min(1, delta/|r|)^0.5 of the unweighted residual r
    [E,M,3] (a constant of the step: it carries no derivative)."""
    w = data.mask.to(r.dtype)
    if delta is not None:
        n = torch.linalg.norm(r, dim=-1)
        w = w * torch.sqrt((delta / n.clamp_min(1e-12)).clamp_max(1.0))
    return w


def _residuals(params, data: PoseGraphData, delta=None):
    """Stacked match residuals [E*M*3], optionally Huber-weighted.

    With ``delta``, each match's 3D residual is scaled by the sqrt-Huber
    IRLS weight (``_weights``; standard IRLS): the few outlier matches the
    RANSAC cascade keeps would otherwise drag the optimum away from an
    exact init by far more than the inlier noise floor."""
    s, R, t = _params_to_sim(params)
    sk, sl = data.seq_k, data.seq_l
    Tp = (s[sk][:, None, None] *
          torch.einsum("eij,emj->emi", R[sk], data.p) + t[sk][:, None, :])
    Tq = (s[sl][:, None, None] *
          torch.einsum("eij,emj->emi", R[sl], data.q) + t[sl][:, None, :])
    r = (Tp - Tq) * data.mask[..., None].to(Tp.dtype)
    if delta is not None:
        r = r * _weights(r, data, delta)[..., None]
    return r.reshape(-1)


def _jacobian(params, data: PoseGraphData, delta=None):
    """[E*M*3, 7S] Jacobian of ``_residuals`` in closed form (the weights
    held constant)."""
    S = params.shape[0]
    E, M = data.mask.shape
    s, R, _ = _params_to_sim(params)
    Jr = _so3_right_jacobian(params[:, 1:4])
    w = _weights(_residuals(params, data).reshape(E, M, 3), data, delta)
    eye = torch.eye(3, dtype=params.dtype, device=params.device)

    def block(seq, pts, sign):                       # -> [E, M*3, 7]
        sc = (sign * s[seq])[:, None, None] * w[..., None]       # [E,M,1]
        d_logs = sc * torch.einsum("eij,emj->emi", R[seq], pts)
        d_rot = -sc[..., None] * (R[seq][:, None] @ _skew(pts) @
                                  Jr[seq][:, None])
        d_t = (sign * w)[..., None, None] * eye
        return torch.cat([d_logs[..., None], d_rot, d_t], -1).reshape(
            E, M * 3, 7)
    J = torch.zeros(E, M * 3, S, 7, dtype=params.dtype,
                    device=params.device)
    e = torch.arange(E, device=params.device)
    J[e, :, data.seq_k, :] = block(data.seq_k, data.p, 1.0)
    J[e, :, data.seq_l, :] = block(data.seq_l, data.q, -1.0)
    return J.reshape(E * M * 3, S * 7)


def _gn_step(params, data: PoseGraphData, lam, delta):
    """One damped GN step (last sequence's columns zeroed: the gauge).
    Returns (new params [S,7], the step's starting cost)."""
    S = params.shape[0]
    flat = params.reshape(-1)
    r = _residuals(params, data, delta)
    J = _jacobian(params, data, delta)              # [R, 7S]
    free = torch.ones(S, 7, dtype=flat.dtype, device=flat.device)
    free[S - 1] = 0.0
    free = free.reshape(-1)
    J = J * free[None, :]
    H = J.T @ J + lam * torch.eye(J.shape[1], dtype=J.dtype,
                                  device=J.device)
    step = torch.linalg.solve(H, -(J.T @ r)) * free
    return (flat + step).reshape(S, 7), (r ** 2).sum()


def _log_params(init: List[Similarity]) -> np.ndarray:
    """(log s, axis-angle, t) per similarity, on the host."""
    params = np.zeros((len(init), 7), np.float32)
    for k, T in enumerate(init):
        params[k, 0] = np.log(max(float(T.s), 1e-9))
        R = T.R.cpu().numpy().astype(np.float64)
        cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
        ang = np.arccos(cos)
        if ang > 1e-9:
            ax = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                           R[1, 0] - R[0, 1]]) / (2 * np.sin(ang))
            params[k, 1:4] = (ax * ang).astype(np.float32)
        params[k, 4:7] = T.t.cpu().numpy()
    return params


def _masked_median(x, mask) -> float:
    """Median of x[mask] with linear interpolation (nanquantile's 0.5);
    0 when the mask is empty."""
    v = torch.sort(x[mask]).values
    if len(v) == 0:
        return 0.0
    pos = 0.5 * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return float(v[lo] + (pos - lo) * (v[hi] - v[lo]))


def refine_pose_graph(init: List[Similarity], data: PoseGraphData, *,
                      iters: int = 20, lam0: float = 1e-4,
                      stagnation_rtol: float = 1e-6
                      ) -> Tuple[List[Similarity], float]:
    """Damped-GN refinement from the greedy-chain initialization, on the
    device of ``data``. A step is accepted only if it lowers the total
    (Huber-weighted) cost, and the loop stops as soon as an accepted step
    improves it by less than ``stagnation_rtol`` relative, so an init at
    the optimum is left essentially untouched. Each iteration reads the
    cost on the host. Returns (similarities on the CPU, unweighted match
    RMSE)."""
    S = len(init)
    p = torch.as_tensor(_log_params(init), device=data.p.device)
    lam = lam0

    # Huber scale from the init residuals: 3x the masked-median match
    # error (floored, so an exactly-zero init does not zero every weight),
    # fixed across iterations so accepted-step costs compare
    n0 = torch.linalg.norm(_residuals(p, data).reshape(-1, 3), dim=-1)
    med = _masked_median(n0, data.mask.reshape(-1))
    delta = torch.tensor(max(3.0 * med, 1e-6), dtype=torch.float32,
                         device=p.device)

    best_cost = float(torch.sum(_residuals(p, data, delta) ** 2))
    for _ in range(iters):
        cand, _ = _gn_step(p, data, lam, delta)
        cost = float(torch.sum(_residuals(cand, data, delta) ** 2))
        if cost < best_cost:
            rel_gain = (best_cost - cost) / max(best_cost, 1e-30)
            p, best_cost = cand, cost
            lam = max(lam * 0.5, 1e-8)
            if rel_gain < stagnation_rtol:
                break
        else:
            lam = min(lam * 4.0, 1e4)
        if lam >= 1e4:
            break

    s, R, t = (x.cpu() for x in _params_to_sim(p))
    out = [Similarity(s[k], R[k], t[k]) for k in range(S)]
    n = data.mask.sum().clamp_min(1)
    # the unweighted RMSE, the metric callers compare across runs
    rmse = float(torch.sqrt(torch.sum(_residuals(p, data) ** 2) / n))
    return out, rmse
