"""Union-find + largest-connected-component mesh trim (host-side).

Re-design of SetUtils/UnionSetUtils.{h,cpp} (path compression + size-rank
merge, UnionSetUtils.cpp:10-45; ``pipeline/ba_refine`` merges match
tracks with it) and Alignment::RetainConnectRegion (Alignment.cpp:618-654):
keep the faces/vertices of the largest edge-connected component. The
components are exact (scipy's graph search on the host), where the JAX
package stops its label propagation after 64 rounds.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components


class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)
        self.size = np.ones(n, np.int64)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:   # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]

    def prominent(self) -> int:
        """Root of the largest set (ProminentRepresent,
        UnionSetUtils.cpp:35-45)."""
        roots = np.array([self.find(i) for i in range(len(self.parent))])
        vals, counts = np.unique(roots, return_counts=True)
        return int(vals[np.argmax(counts)])


def _components(n_vertices: int, edges: np.ndarray) -> np.ndarray:
    """Exact connected components (scipy's graph search) -> per-vertex
    labels, each component labelled by its smallest vertex id: the labels
    min-label propagation reaches at its fixpoint."""
    if len(edges) == 0:
        return np.arange(n_vertices)
    graph = coo_matrix((np.ones(len(edges), np.int8),
                        (edges[:, 0], edges[:, 1])),
                       shape=(n_vertices, n_vertices))
    _, comp = connected_components(graph, directed=False)
    _, first = np.unique(comp, return_index=True)
    return first[comp]


def retain_largest_component(vertices: np.ndarray, faces: np.ndarray,
                             normals: np.ndarray | None = None):
    """Keep only the largest edge-connected face component
    (RetainConnectRegion, Alignment.cpp:618-654). Returns
    (vertices, faces, normals) reindexed."""
    if len(faces) == 0:
        return vertices, faces, normals
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
    labels = _components(len(vertices), edges)
    vals, counts = np.unique(labels[faces[:, 0]], return_counts=True)
    keep_root = vals[np.argmax(counts)]
    fmask = labels[faces[:, 0]] == keep_root
    faces_kept = faces[fmask]
    used = np.zeros(len(vertices), bool)
    used[faces_kept.ravel()] = True
    remap = np.cumsum(used) - 1
    out_faces = remap[faces_kept]
    out_verts = vertices[used]
    out_norms = normals[used] if normals is not None and len(normals) else None
    return out_verts, out_faces.astype(np.int32), out_norms


def largest_point_component(points: np.ndarray, radius: float):
    """Largest cluster of a point set under `radius`-NN connectivity —
    used by RemoveGround's candidate filtering (Alignment.cpp:207-227).
    Returns a boolean mask. O(N^2) distance matrix — fine for the sizes
    the alignment stage feeds (thousands)."""
    n = len(points)
    if n == 0:
        return np.zeros(0, bool)
    d2 = ((points[:, None, :] - points[None]) ** 2).sum(-1)
    adj = d2 <= radius * radius
    ii, jj = np.nonzero(np.triu(adj, 1))
    labels = _components(n, np.stack([ii, jj], -1))
    vals, counts = np.unique(labels, return_counts=True)
    return labels == vals[np.argmax(counts)]
