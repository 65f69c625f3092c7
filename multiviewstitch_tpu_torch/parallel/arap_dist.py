"""Distributed ARAP: edge-sharded local-global iterations.

PyTorch counterpart of ``multiviewstitch_tpu/parallel/arap_dist.py`` (the
deformation-graph parallelism of BASELINE: "deformation-graph blocks
partitioned per host ... solves via collectives"):

  - EDGES (with their cotangent weights) are block-sharded over the ranks:
    the rotation-fitting covariances, the right-hand side and the
    Laplacian matvec are edge sums, so each rank scatters its edge block
    into per-vertex partials and one ``all_reduce`` gives the whole sum.
  - VERTEX STATE is replicated: every rank runs the same Jacobi-
    preconditioned CG (``solvers/deformation._cg``) on identical
    all-reduced vectors, so its dot products need no collective; the CG
    runs its fixed iteration count with no host read, and the converged
    state is frozen (``torch.where``) at the same iteration on every
    rank.

The math is ``solvers/deformation.arap_solve``'s edge-scatter CG path
(with its rotation fit and tie bound); sums are taken in another order,
so the two agree to float32 reduction tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solvers.deformation import (TIE_REL, ARAPProblem, _cg,
                                   _laplacian_matvec, _scatter_edges,
                                   fit_rotation, rotation_covariances)
from .mesh import Mesh, all_reduce_sum, shard_along


def pad_edges(edges: np.ndarray, weights: np.ndarray, n_devices: int):
    """Pad the edge list to a device-divisible count with zero-weight
    self-loops on vertex 0 (no-ops in every edge sum)."""
    e = np.asarray(edges)
    w = np.asarray(weights)
    padn = (-len(e)) % n_devices
    if padn:
        e = np.concatenate([e, np.zeros((padn, 2), e.dtype)])
        w = np.concatenate([w, np.zeros(padn, w.dtype)])
    return e, w


def arap_solve_sharded(prob: ARAPProblem, *, mesh: Mesh,
                       outer_iters: int = 5, cg_iters: int = 200,
                       tol: float = 1e-4) -> torch.Tensor:
    """Edge-sharded ARAP local-global solve (the edge count must divide by
    the mesh size: ``pad_edges``). Returns the [V,3] positions on every
    rank."""
    dev = mesh.device
    rest = prob.rest.to(dev)
    con = prob.constrained.to(dev)
    free = ~con
    nv = rest.shape[0]
    e = shard_along(mesh, prob.edges)
    i, j = e[:, 0].long(), e[:, 1].long()
    w = shard_along(mesh, prob.weights)

    deg = all_reduce_sum(mesh, torch.zeros(nv, dtype=rest.dtype, device=dev)
                         .index_add_(0, i, w).index_add_(0, j, w))
    dinv = torch.where(free, 1.0 / deg.clamp_min(1e-9), torch.ones_like(deg))

    def mv(x):
        y = all_reduce_sum(mesh, _laplacian_matvec(
            torch.where(free[:, None], x, torch.zeros_like(x)), i, j, w))
        return torch.where(free[:, None], y, torch.zeros_like(y))

    p = torch.where(con[:, None], prob.targets.to(dev), rest)
    gd = rest[i] - rest[j]
    tie = TIE_REL * rest.abs().amax()
    for _ in range(outer_iters):
        R = fit_rotation(all_reduce_sum(mesh, rotation_covariances(
            gd, p[i] - p[j], w, tie, nv, i, j)))
        # rhs_i = sum_j w/2 (R_i + R_j)(g_i - g_j), minus the constrained
        # vertices' contribution: one edge sum
        Rij = 0.5 * (R[i] + R[j])
        rot_gd = w[:, None] * (Rij * gd[:, None, :]).sum(-1)
        b = all_reduce_sum(mesh, _scatter_edges(nv, i, j, rot_gd) -
                           _laplacian_matvec(torch.where(
                               con[:, None], p, torch.zeros_like(p)),
                               i, j, w))
        b = torch.where(free[:, None], b, torch.zeros_like(b))
        x0 = torch.where(free[:, None], p, torch.zeros_like(p))
        x = _cg(mv, b, x0, cg_iters, tol, lambda r: dinv[:, None] * r)
        p = torch.where(free[:, None], x, p)
    return p
