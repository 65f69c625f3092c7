"""Distributed bundle adjustment: point-sharded Schur reduction.

PyTorch counterpart of ``multiviewstitch_tpu/parallel/ba_dist.py`` (the
BASELINE pattern "distributed BA via Schur-complement reduction over
collectives"):

  - POINTS, with all of each point's observations (the per-point grouped
    [P,M] layout), are block-sharded over the ranks; CAMERAS (6C dof) are
    replicated.
  - each rank builds its partial reduced camera system S, b with the
    single-device solver's ``solvers/ba._grouped_schur_terms``; one
    ``all_reduce`` each for S and b gives the full system on every rank;
    the dense solve (``solve_reduced``) is replicated; the points' back
    substitution (``back_substitute_points``) stays local.
  - the LM loop is ``solvers/ba.lm_solve``'s (a fixed number of
    iterations, accept / reject by ``torch.where``, no host read, the
    state frozen once the damping reaches 1e3), given the sharded step and
    an RMSE that takes one ``all_reduce`` of (squared sum, count).

Sums are taken in another order than the single-device solve's, so the
two agree to float32 reduction tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..solvers.ba import (BAState, _group_ranks, _grouped_schur_terms,
                          _project, back_substitute_points, lm_solve,
                          lm_update, rodrigues, solve_reduced)
from .mesh import Mesh, all_reduce_sum, block_range, gather_along


class BAPointBlocks(NamedTuple):
    """Per-point grouped observations, padded to [P, M]."""
    K: torch.Tensor           # [3,3]
    cam_of: torch.Tensor      # [P,M] int64 camera per observation slot
    uv: torch.Tensor          # [P,M,2]
    mask: torch.Tensor        # [P,M] bool
    fixed_cams: torch.Tensor  # [C] bool


def group_by_point(K, cam_idx, pt_idx, uv, n_points: int, n_cams: int,
                   max_obs_per_point: int = 16, fixed_cams=(0,), *,
                   device) -> BAPointBlocks:
    """Host-side grouping of flat observations into the [P,M] layout: the
    first ``max_obs_per_point`` observations of each point, in
    observation order."""
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv, np.float32)
    cam_of = np.zeros((n_points, max_obs_per_point), np.int64)
    uvp = np.zeros((n_points, max_obs_per_point, 2), np.float32)
    mask = np.zeros((n_points, max_obs_per_point), bool)
    slot, keep = _group_ranks(pt_idx, max_obs_per_point)
    sel = np.argsort(pt_idx, kind="stable")[keep]
    cam_of[pt_idx[sel], slot[keep]] = cam_idx[sel]
    uvp[pt_idx[sel], slot[keep]] = uv[sel]
    mask[pt_idx[sel], slot[keep]] = True
    fc = np.zeros(n_cams, bool)
    fc[list(fixed_cams)] = True
    return BAPointBlocks(
        *(torch.as_tensor(a, device=device) for a in (
            np.asarray(K, np.float32), cam_of, uvp, mask, fc)))


def _squared_sum(prob: BAPointBlocks, st: BAState):
    """(sum of squared residual components, observation count) as one
    float32 [2] tensor."""
    P, M = prob.cam_of.shape
    R = rodrigues(st.rvec)
    _, _, u, v = _project(prob.K, R[prob.cam_of], st.tvec[prob.cam_of],
                          st.points[:, None, :].expand(P, M, 3))
    r2 = (u - prob.uv[..., 0]) ** 2 + (v - prob.uv[..., 1]) ** 2
    return torch.stack([torch.where(prob.mask, r2, 0.0).sum(),
                        prob.mask.sum().to(r2.dtype)])


def _rmse(sums):
    return torch.sqrt(sums[0] / (2 * sums[1].clamp_min(1)))


def reprojection_rmse_blocks(prob: BAPointBlocks, st: BAState):
    """RMSE over the masked observations' residual components (0-dim)."""
    return _rmse(_squared_sum(prob, st))


def shard_problem(prob: BAPointBlocks, mesh: Mesh) -> BAPointBlocks:
    """This rank's point block (K and the fixed cameras replicated) on the
    rank's device."""
    s, e = block_range(mesh, prob.cam_of.shape[0])
    dev = mesh.device
    return BAPointBlocks(prob.K.to(dev), prob.cam_of[s:e].to(dev),
                         prob.uv[s:e].to(dev), prob.mask[s:e].to(dev),
                         prob.fixed_cams.to(dev))


def shard_state(st: BAState, mesh: Mesh) -> BAState:
    """The cameras and this rank's point block on the rank's device."""
    s, e = block_range(mesh, st.points.shape[0])
    dev = mesh.device
    return BAState(st.rvec.to(dev), st.tvec.to(dev), st.points[s:e].to(dev))


def rmse_sharded(blk: BAPointBlocks, st: BAState, mesh: Mesh):
    """The RMSE over every rank's points: one ``all_reduce``."""
    return _rmse(all_reduce_sum(mesh, _squared_sum(blk, st)))


def _step_local(blk: BAPointBlocks, st: BAState, lam, mesh: Mesh) -> BAState:
    """One damped GN step of the rank-local state: partial S, b, one
    ``all_reduce`` each, the replicated solve, local back substitution."""
    S, b, Hpp_inv, W, bp = _grouped_schur_terms(
        blk.K, st.rvec, st.tvec, st.points, blk.cam_of, blk.uv, blk.mask,
        lam)
    dc = solve_reduced(all_reduce_sum(mesh, S), all_reduce_sum(mesh, b), lam,
                       blk.fixed_cams)
    dp = back_substitute_points(W, Hpp_inv, bp, blk.cam_of, dc)
    return BAState(st.rvec + dc[:, :3], st.tvec + dc[:, 3:], st.points + dp)


def gn_step_sharded(prob: BAPointBlocks, st: BAState, lam, *,
                    mesh: Mesh) -> BAState:
    """One damped GN / Schur step with the points sharded over the mesh;
    returns the whole state on every rank."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=mesh.device)
    new = _step_local(shard_problem(prob, mesh), shard_state(st, mesh), lam,
                      mesh)
    return new._replace(points=gather_along(mesh, new.points))


def _lm_hooks(blk: BAPointBlocks, mesh: Mesh):
    """(step, rmse) of the rank-local state for ``solvers/ba.lm_update``."""
    return (lambda st, lam: _step_local(blk, st, lam, mesh),
            lambda st: rmse_sharded(blk, st, mesh))


def lm_step_sharded(blk: BAPointBlocks, st: BAState, best, lam, mesh: Mesh):
    """One LM iteration of the rank-local state (``shard_state``):
    ``solvers/ba.lm_update`` with the sharded GN step and RMSE. Returns
    (state, best, lam); no host read."""
    return lm_update(*_lm_hooks(blk, mesh), st, best, lam)


def solve_ba_sharded(prob: BAPointBlocks, st: BAState, mesh: Mesh, *,
                     iters: int = 20, lam0: float = 1e-3
                     ) -> Tuple[BAState, float]:
    """Sharded LM solve (``solvers/ba.lm_solve``): ``iters`` iterations
    from damping ``lam0``; the one host read is the final RMSE. The point
    count must divide by the mesh size (pad with all-false masks). Returns
    (whole state on every rank, RMSE in pixels)."""
    blk = shard_problem(prob, mesh)
    stl, best, _ = lm_solve(*_lm_hooks(blk, mesh), shard_state(st, mesh),
                            iters=iters, lam0=lam0)
    return (stl._replace(points=gather_along(mesh, stl.points)),
            float(best))
