"""Mesh simplification by quadric-error edge collapse.

The port's copy of ``multiviewstitch_tpu/ops/simplify.py`` (host numpy).
Parity for Deformation::Simplification (Deformation.cpp:48-61), which wraps
CGAL's Surface_mesh_simplification edge_collapse with a count-ratio stop
criterion (unused in the reference's main path, but part of its surface).
Host-side numpy QEM (Garland-Heckbert): per-vertex quadrics from face
planes, greedy min-cost collapses to a target vertex ratio, midpoint
placement. Small meshes only — this runs off the hot path.
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np


def simplify_mesh(vertices: np.ndarray, faces: np.ndarray,
                  ratio: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse edges until vertex count <= ratio * original."""
    V = np.asarray(vertices, np.float64).copy()
    F = np.asarray(faces, np.int64).copy()
    n = len(V)
    target = max(int(n * ratio), 4)

    # per-vertex quadrics from incident face planes
    Q = np.zeros((n, 4, 4))
    p0, p1, p2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    nrm = np.cross(p1 - p0, p2 - p0)
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    ok = ln[:, 0] > 1e-12
    nrm = np.where(ok[:, None], nrm / np.maximum(ln, 1e-12), 0.0)
    d = -(nrm * p0).sum(1)
    planes = np.concatenate([nrm, d[:, None]], 1)       # [F,4]
    K = planes[:, :, None] * planes[:, None, :]         # [F,4,4]
    for k in range(3):
        np.add.at(Q, F[:, k], K)

    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    # candidate edges
    E = np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]])
    E = np.unique(np.sort(E, 1), axis=0)

    def cost(a, b):
        q = Q[a] + Q[b]
        mid = 0.5 * (V[a] + V[b])
        h = np.append(mid, 1.0)
        return float(h @ q @ h), mid

    heap = []
    for a, b in E:
        c, _ = cost(a, b)
        heapq.heappush(heap, (c, int(a), int(b)))

    alive = np.ones(n, bool)
    n_alive = n
    while n_alive > target and heap:
        c, a, b = heapq.heappop(heap)
        ra, rb = find(a), find(b)
        if ra == rb or not (alive[ra] and alive[rb]):
            continue
        c2, mid = cost(ra, rb)
        if c2 > c + 1e-12:           # stale entry: re-push with fresh cost
            heapq.heappush(heap, (c2, ra, rb))
            continue
        # collapse rb into ra at the midpoint
        V[ra] = mid
        Q[ra] = Q[ra] + Q[rb]
        parent[rb] = ra
        alive[rb] = False
        n_alive -= 1

    root = np.array([find(i) for i in range(n)])
    F2 = root[F]
    good = ((F2[:, 0] != F2[:, 1]) & (F2[:, 1] != F2[:, 2]) &
            (F2[:, 0] != F2[:, 2]))
    F2 = F2[good]
    used = np.zeros(n, bool)
    used[F2.ravel()] = True
    remap = np.cumsum(used) - 1
    return (V[used].astype(np.float32),
            remap[F2].astype(np.int32))
