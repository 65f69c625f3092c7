"""Block-partitioned deformation graph: vertex blocks plus a halo.

PyTorch counterpart of ``multiviewstitch_tpu/parallel/arap_blocks.py``
(SURVEY §2: "partition deformation-graph nodes into blocks per device;
matvecs use halo exchange along graph cuts; global reductions"). Where
``parallel/arap_dist`` shards the edge work and replicates the vertices,
this is the memory-scaling layout:

  - VERTICES are split into contiguous index blocks of B = ceil(V/D); each
    rank holds its block's state ([B,3], sharded) and the edges whose FIRST
    endpoint it owns.
  - the halo is explicit: a rank publishes only its boundary vertices (the
    ones another rank's edges reference). One ``all_gather`` of the
    [Hmax,...] published rows is the halo exchange; the contributions an
    edge sum makes to another rank's vertices ride one ``all_reduce`` of
    the [D,Hmax,...] slot table. Per-rank state is O(V/D + D*Hmax).
  - CG's dot products are sums over the ranks' blocks (one ``all_reduce``
    each). The CG runs its fixed iteration count with no host read; the
    all-reduced residual freezes every rank's state at the same
    iteration.

The math is ``solvers/deformation.arap_solve``'s edge-scatter CG path
(its rotation fit and tie bound included); sums are taken in another
order, so the two agree to float32 reduction tolerance.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..solvers.ba import _group_ranks
from ..solvers.deformation import (TIE_REL, _cg, fit_rotation,
                                   rotation_covariances)
from .mesh import Mesh, all_reduce_sum, gather_along


class ARAPBlockProblem(NamedTuple):
    """Every array has a leading rank axis D (rank d takes index d)."""
    rest: torch.Tensor          # [D,B,3]
    targets: torch.Tensor       # [D,B,3]
    constrained: torch.Tensor   # [D,B] bool (padding vertices pinned)
    edge_codes: torch.Tensor    # [D,Em,2] int64 local codes (below)
    weights: torch.Tensor       # [D,Em] float32 (0 = padding)
    pub: torch.Tensor           # [D,Hmax] int64 local ids of published
    n_vertices: int             # V before padding


def build_blocks(rest, edges, weights, constrained, targets,
                 n_devices: int) -> ARAPBlockProblem:
    """Host-side partitioner (CPU tensors): contiguous vertex blocks, edge
    ownership by first endpoint, published-boundary / halo addressing. An
    edge endpoint's code is its local id when the edge's owner holds it,
    else B + owner * Hmax + its slot in the owner's published list."""
    rest = np.asarray(rest, np.float32)
    targets = np.asarray(targets, np.float32)
    constrained = np.asarray(constrained, bool)
    edges = np.asarray(edges, np.int64)
    weights = np.asarray(weights, np.float32)
    V = len(rest)
    D = n_devices
    B = -(-V // D)
    Vp = B * D

    owner = np.minimum(np.arange(Vp) // B, D - 1)
    eo = owner[edges[:, 0]]

    # published set per device: owned vertices referenced by foreign edges
    vs = edges.ravel()
    foreign = owner[vs] != np.repeat(eo, 2)
    pub_v = np.unique(vs[foreign])                  # sorted globally, so
    pub_owner = owner[pub_v]                        # sorted per device too
    Hmax = max(int(np.bincount(pub_owner, minlength=D).max())
               if len(pub_v) else 1, 1)
    slot = np.zeros(Vp, np.int64)
    pub = np.zeros((D, Hmax), np.int64)
    starts = np.searchsorted(pub_owner, np.arange(D))
    sl = np.arange(len(pub_v)) - starts[pub_owner]
    slot[pub_v] = sl
    pub[pub_owner, sl] = pub_v - pub_owner * B

    Em = max(int(np.bincount(eo, minlength=D).max()) if len(edges) else 1,
             1)
    codes = np.zeros((D, Em, 2), np.int64)
    w = np.zeros((D, Em), np.float32)
    rank, _ = _group_ranks(eo, Em)
    order = np.argsort(eo, kind="stable")
    es, dofs = edges[order], eo[order]
    for c in range(2):
        v = es[:, c]
        codes[dofs, rank, c] = np.where(owner[v] == dofs, v - dofs * B,
                                        B + owner[v] * Hmax + slot[v])
    w[dofs, rank] = weights[order]

    def blk(x, fill=0.0):
        xp = np.full((Vp,) + x.shape[1:], fill, x.dtype)
        xp[:V] = x
        return torch.as_tensor(xp.reshape((D, B) + x.shape[1:]))

    return ARAPBlockProblem(blk(rest), blk(targets),
                            blk(constrained, fill=True),
                            torch.as_tensor(codes), torch.as_tensor(w),
                            torch.as_tensor(pub), V)


def arap_solve_blocks(prob: ARAPBlockProblem, *, mesh: Mesh,
                      outer_iters: int = 5, cg_iters: int = 200,
                      tol: float = 1e-4) -> torch.Tensor:
    """Vertex-block-sharded ARAP local-global solve over a mesh of as many
    ranks as ``prob`` has blocks. Returns the [V,3] positions on every
    rank (one ``all_gather`` of the blocks at the end)."""
    D, B = prob.rest.shape[:2]
    if D != mesh.size:
        raise ValueError(f"{D} blocks for a mesh of {mesh.size} ranks")
    r, dev = mesh.rank, mesh.device
    Hmax = prob.pub.shape[1]
    rest, tgt, con, codes, w, pub = (
        x[r].to(dev) for x in (prob.rest, prob.targets, prob.constrained,
                               prob.edge_codes, prob.weights, prob.pub))
    free = ~con
    ei, ej = codes[:, 0], codes[:, 1]
    n_slots = B + D * Hmax

    def ext(x):
        """own block [B,k] -> [B + D*Hmax, k] with the halo gathered."""
        return torch.cat([x, gather_along(mesh, x[pub])])

    def settle(acc):
        """Slot sums [B + D*Hmax, ...] -> the owned rows' sums, with the
        contributions other ranks' edges made to them (one all_reduce)."""
        remote = all_reduce_sum(mesh, acc[B:].contiguous())
        return acc[:B].index_add_(0, pub, remote.view(
            (D, Hmax) + acc.shape[1:])[r])

    def edge_sum(val):
        acc = torch.zeros((n_slots,) + val.shape[1:], dtype=val.dtype,
                          device=dev)
        return settle(acc.index_add_(0, ei, val).index_add_(0, ej, -val))

    def lap(pv):
        pe = ext(pv)
        return edge_sum(w[:, None] * (pe[ei] - pe[ej]))

    def lap_free(x):
        y = lap(torch.where(free[:, None], x, torch.zeros_like(x)))
        return torch.where(free[:, None], y, torch.zeros_like(y))

    def pdot(a, b):
        return all_reduce_sum(mesh, (a * b).sum())

    deg = settle(torch.zeros(n_slots, dtype=w.dtype, device=dev)
                 .index_add_(0, ei, w).index_add_(0, ej, w))
    dinv = torch.where(free, 1.0 / deg.clamp_min(1e-9), torch.ones_like(deg))
    rest_e = ext(rest)
    gd = rest_e[ei] - rest_e[ej]
    amax = rest.abs().amax()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    tie = TIE_REL * amax

    p = torch.where(con[:, None], tgt, rest)
    for _ in range(outer_iters):
        pe = ext(p)
        R = fit_rotation(settle(rotation_covariances(
            gd, pe[ei] - pe[ej], w, tie, n_slots, ei, ej)))
        Re = ext(R.reshape(B, 9)).reshape(-1, 3, 3)
        Rij = 0.5 * (Re[ei] + Re[ej])
        rot_gd = w[:, None] * (Rij * gd[:, None, :]).sum(-1)
        b = edge_sum(rot_gd) - lap(torch.where(con[:, None], p,
                                               torch.zeros_like(p)))
        b = torch.where(free[:, None], b, torch.zeros_like(b))
        x = _cg(lap_free, b, torch.where(free[:, None], p,
                                         torch.zeros_like(p)),
                cg_iters, tol, lambda q: dinv[:, None] * q, dot=pdot)
        p = torch.where(free[:, None], x, p)
    return gather_along(mesh, p)[:prob.n_vertices]


def per_device_state_bytes(prob: ARAPBlockProblem) -> int:
    """Vertex-state bytes a rank holds (block + halo table): the quantity
    that scales ~1/D against the replicated solver's V."""
    D, B = prob.rest.shape[:2]
    Hmax = prob.pub.shape[1]
    return (B + D * Hmax) * 3 * 4
