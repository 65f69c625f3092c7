"""Non-rigid surface deformation: ARAP local-global solve in PyTorch.

PyTorch counterpart of ``multiviewstitch_tpu/solvers/deformation.py``
(Deformation/Deformation.{h,cpp}): control vertices by greedy decimation
(UniformSampling, Deformation.cpp:63-106), a target per control by a
radius search with normal / projection filters (Deform, 232-356), two
rounds of 8-NN displacement smoothing (358-381), and the ARAP
local-global solve CGAL's ``Surface_mesh_deformation`` runs (383-400).

  - control sampling and the k-NN graph use scipy's cKDTree on the host,
    as the JAX package does, with near-tied distances ordered by index
    (``stable_knn``): the control set is then the same under float noise,
    and the JAX package's wherever no two distances are within the tie
    bound
  - the correspondence search is one exact [C,T] distance pass (direct
    differences, float32) with a top-k over the candidates
  - ARAP: the local step fits every vertex's rotation with Horn's
    quaternion form (``fit_rotation``); the global step is a Cholesky
    factorisation of the free-masked Laplacian done once per solve
    (V <= 4096) or a Jacobi-preconditioned CG over edge scatters whose
    converged iterations freeze through ``torch.where``, so no iteration
    reads a value back to the host
Nothing here runs a hand-written kernel: the JAX module has no Pallas
kernel either.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import count, span

# ---------------------------------------------------------------------------
# control sampling + knn weights (host-side graph construction)
# ---------------------------------------------------------------------------

# neighbour distances closer than this share of the largest coordinate
# count as tied (~80 float32 ulps of it)
TIE_REL = 1e-5
# the least cosine between a control's normal and a candidate's
FACING_MIN = 1e-3


def stable_knn(points: np.ndarray, k: int) -> np.ndarray:
    """[N,k] indices of every point's k nearest points (itself included),
    by cKDTree. Distances within TIE_REL * max|coordinate| of their
    neighbour in the sorted list count as one tie, ordered by index, so
    rounding noise far below that bound (the mirror pairs of a symmetric
    mesh after a float32 transform, or the card's sums against the CPU's)
    never changes the set; cKDTree alone orders such ties by the noise."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    n = len(pts)
    k = min(k, n)
    tie = TIE_REL * float(np.abs(pts).max(initial=0.0))
    tree = cKDTree(pts)
    m = min(n, 2 * k)
    while True:
        d, idx = tree.query(pts, k=m)
        d, idx = d.reshape(n, m), idx.reshape(n, m)
        group = np.concatenate(
            [np.zeros((n, 1), np.int64),
             np.cumsum(np.diff(d, axis=1) > tie, axis=1)], axis=1)
        # the tie group at rank k must end inside the query
        if m == n or (group[:, -1] > group[:, k - 1]).all():
            break
        m = min(n, 2 * m)
    order = np.lexsort((idx, group), axis=1)
    return np.take_along_axis(idx, order, axis=1)[:, :k]


def uniform_sampling(points: np.ndarray, k: int = 16) -> np.ndarray:
    """Greedy decimation (UniformSampling, Deformation.cpp:63-106): walk
    vertices in index order; keep a vertex unless already removed, then
    remove its k nearest neighbors (``stable_knn``). Returns kept indices
    (sampIdx)."""
    removed = np.zeros(len(points), bool)
    keep = []
    knn = stable_knn(points, k)
    for i in range(len(points)):
        if not removed[i]:
            keep.append(i)
            removed[knn[i]] = True
            removed[i] = False
    return np.asarray(keep, np.int64)


def knn_graph(points: np.ndarray, k: int = 8
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(K+1)-NN (self included, ``stable_knn``) with uniform 1/(K+1)
    weights — the reference's KNearestNeighbor(8)
    (Deformation.cpp:108-153)."""
    idx = stable_knn(points, k + 1)
    w = np.full(idx.shape, 1.0 / (k + 1), np.float32)
    return idx.astype(np.int32), w


# ---------------------------------------------------------------------------
# correspondence search
# ---------------------------------------------------------------------------

class Correspondences(NamedTuple):
    targets: torch.Tensor   # [C,3] target positions (controls when invalid)
    valid: torch.Tensor     # [C] bool


def find_correspondences(controls, control_normals, tpts, tnormals, *,
                         proj_len_err: float = 100.0,
                         proj_dist_err: float = 100.0,
                         max_neighbors: int = 8) -> Correspondences:
    """Per-control target search (Deform, Deformation.cpp:266-356):
    candidates within sqrt(2) * the nearest distance, same-facing normals,
    ranked by (projDist, |projLen|), the best <= 8 averaged; reject by the
    mean projections and a near-perpendicular displacement direction.
    controls / control_normals [C,3], tpts / tnormals [T,3]."""
    dirs = tpts[None, :, :] - controls[:, None, :]             # [C,T,3]
    d2 = (dirs * dirs).sum(-1)                                 # [C,T]
    d2min = d2.amin(1, keepdim=True)
    in_radius = d2 <= 2.0 * d2min + 1e-12                      # flann L2^2

    nrm = control_normals / torch.linalg.norm(
        control_normals, dim=-1, keepdim=True).clamp_min(1e-12)
    # same-facing by more than FACING_MIN: on a mesh of exact primitives
    # many normal pairs are exactly perpendicular, and a ``> 0`` test
    # would take them by rounding noise
    facing = (nrm[:, None, :] * tnormals[None, :, :]).sum(-1) > FACING_MIN
    ok = in_radius & facing

    proj_len = (dirs * nrm[:, None, :]).sum(-1)
    proj_dist = torch.sqrt((d2 - proj_len ** 2).clamp_min(0.0))

    # rank: smallest projDist first, |projLen| tie-break; of the best
    # 4 * max_neighbors, scores within the stable_knn tie bound of their
    # neighbour in the sorted list are ordered by index
    score = proj_dist + 1e-6 * proj_len.abs()
    score = torch.where(ok, score, torch.full_like(score, float("inf")))
    n_t = score.shape[1]
    k = min(max_neighbors, n_t)
    cand, cand_idx = torch.topk(-score, min(4 * k, n_t), dim=1)
    cand = -cand
    tie = TIE_REL * tpts.abs().amax()
    group = torch.cat([torch.zeros_like(cand_idx[:, :1]),
                       (cand[:, 1:] - cand[:, :-1] > tie).cumsum(1)], 1)
    order = (group * n_t + cand_idx).argsort(dim=1)[:, :k]
    top_idx = cand_idx.gather(1, order)
    top_ok = torch.isfinite(cand.gather(1, order))
    cnt = top_ok.sum(-1).clamp_min(1).to(controls.dtype)

    def mean_of(c_mat):
        v = torch.gather(c_mat, 1, top_idx)
        return torch.where(top_ok, v, torch.zeros_like(v)).sum(-1) / cnt

    m_len = mean_of(proj_len)
    m_dist = mean_of(proj_dist)
    pts = tpts[top_idx]                                        # [C,k,3]
    m_pts = (torch.where(top_ok[..., None], pts, torch.zeros_like(pts))
             .sum(-2) / cnt[:, None])

    accept = top_ok.any(-1) & (m_len < proj_len_err) & \
        (m_dist < proj_dist_err)
    disp = m_pts - controls
    cosang = ((disp * nrm).sum(-1) /
              torch.linalg.norm(disp, dim=-1).clamp_min(1e-12)).abs()
    accept &= cosang >= 0.1                                    # (Deform:352)
    targets = torch.where(accept[:, None], m_pts, controls)
    return Correspondences(targets, accept)


def smooth_displacements(controls, orig, nbr_idx, nbr_w, *, iters: int = 2):
    """Control-displacement smoothing (Deformation.cpp:358-381):
    c_i <- orig_i + sum_j w_ij (c_j - orig_j), ``iters`` rounds.
    nbr_idx [C,K] (int), nbr_w [C,K]."""
    c = controls
    idx = nbr_idx.long()
    for _ in range(iters):
        disp = c - orig
        c = orig + (nbr_w[..., None] * disp[idx]).sum(1)
    return c


# ---------------------------------------------------------------------------
# ARAP local-global solve
# ---------------------------------------------------------------------------

def mesh_edges(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges [E,2] from a face list."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0).astype(np.int32)


def cotangent_weights(verts: np.ndarray, faces: np.ndarray,
                      edges: np.ndarray) -> np.ndarray:
    """Cotangent edge weights (CGAL Surface_mesh_deformation's default ARAP
    weighting), clamped to >= 1e-3, in float64 on the host and returned as
    float32 (the JAX package's host computation, vectorised)."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces)
    # the three (i, j, opposite) rotations of every face, flattened
    i = f[:, [0, 1, 2]].ravel()
    j = f[:, [1, 2, 0]].ravel()
    o = f[:, [2, 0, 1]].ravel()
    a = v[i] - v[o]
    b = v[j] - v[o]
    cos = np.einsum("ni,ni->n", a, b)
    sin = np.linalg.norm(np.cross(a, b), axis=1)
    cot = 0.5 * cos / np.maximum(sin, 1e-9)
    # accumulate onto undirected edges via a sorted-pair key
    V = int(max(i.max(initial=0), j.max(initial=0))) + 1
    key = (np.minimum(i, j).astype(np.int64) * V +
           np.maximum(i, j).astype(np.int64))
    ekey = (np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64) * V +
            np.maximum(edges[:, 0], edges[:, 1]))
    order = np.argsort(ekey)
    pos = np.searchsorted(ekey[order], key)
    acc = np.zeros(len(edges) + 1, np.float64)
    last = np.minimum(pos, len(edges) - 1)
    hit = (pos < len(edges)) & (ekey[order][last] == key)
    np.add.at(acc, np.where(hit, order[last], len(edges)),
              np.where(hit, cot, 0.0))
    return np.maximum(acc[:len(edges)], 1e-3).astype(np.float32)


class ARAPProblem(NamedTuple):
    rest: torch.Tensor         # [V,3] rest positions
    edges: torch.Tensor        # [E,2] int64
    weights: torch.Tensor      # [E]
    constrained: torch.Tensor  # [V] bool
    targets: torch.Tensor      # [V,3] target for constrained verts


def _scatter_edges(nv, i, j, val):
    """sum over edges e of val_e into row i_e and -val_e into row j_e."""
    out = torch.zeros((nv,) + val.shape[1:], dtype=val.dtype,
                      device=val.device)
    return out.index_add_(0, i, val).index_add_(0, j, -val)


def _laplacian_matvec(p, i, j, w):
    """L p with L = sum_e w_e (e_i - e_j)(e_i - e_j)^T, as edge scatters."""
    return _scatter_edges(p.shape[0], i, j, w[:, None] * (p[i] - p[j]))


def fit_rotation(S, squarings: int = 7):
    """Nearest proper rotation R = argmax_R tr(R S) for batched 3x3
    covariances S [...,3,3] — the ARAP local step (R = V diag(1,1,det) U^T
    for S = U Sigma V^T) without an SVD.

    Horn's quaternion form: tr(R S) = q^T K(S^T) q for a unit quaternion
    q, so q is the dominant eigenvector of the symmetric 4x4 K, found by a
    shifted squared power iteration: B = K + sqrt(3) * 1.0001 I, then
    normalise and square ``squarings`` times (power 128); the column of the
    rank-1 limit with the largest diagonal is q. Correct on rank-2 (planar
    one-ring) and reflective (det < 0) covariances; S == 0 (Frobenius norm
    < 1e-18) gives the identity. The 4x4 products are explicit sums of
    elementwise products, so no matmul precision setting (TF32) reaches
    them."""
    A = S.transpose(-1, -2)
    fro = torch.sqrt((S * S).sum((-2, -1), keepdim=True).clamp_min(1e-40))
    A = A / fro
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    K = torch.stack([
        torch.stack([a00 + a11 + a22, a21 - a12, a02 - a20, a10 - a01], -1),
        torch.stack([a21 - a12, a00 - a11 - a22, a01 + a10, a02 + a20], -1),
        torch.stack([a02 - a20, a01 + a10, a11 - a00 - a22, a12 + a21], -1),
        torch.stack([a10 - a01, a02 + a20, a12 + a21, a22 - a00 - a11], -1),
    ], -2)                                                      # [...,4,4]

    # the shift makes K PD (|lambda| <= sqrt(3) ||A||_F = sqrt(3))
    eye4 = torch.eye(4, dtype=S.dtype, device=S.device)
    B = K + (math.sqrt(3.0) * 1.0001) * eye4
    for _ in range(squarings):
        B = B / torch.sqrt((B * B).sum((-2, -1), keepdim=True)
                           .clamp_min(1e-40))
        B = (B[..., :, :, None] * B[..., None, :, :]).sum(-2)
    # dominant eigenvector = the column with the largest diagonal entry of
    # the rank-1 limit (diag_i -> q_i^2, the largest >= 1/4)
    sel = torch.diagonal(B, dim1=-2, dim2=-1).argmax(-1)
    q = torch.take_along_dim(B, sel[..., None, None].expand(
        *sel.shape, 4, 1), dim=-1)[..., 0]
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True).clamp_min(1e-40))

    w_, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w_ * z),
                     2 * (x * z + w_ * y)], -1),
        torch.stack([2 * (x * y + w_ * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w_ * x)], -1),
        torch.stack([2 * (x * z - w_ * y), 2 * (y * z + w_ * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)
    degenerate = fro[..., 0, 0] < 1e-18
    eye3 = torch.eye(3, dtype=S.dtype, device=S.device).expand_as(R)
    return torch.where(degenerate[..., None, None], eye3, R)


def rotation_covariances(gd, pd, w, tie, nv: int, i, j):
    """S_i = sum_j w_ij (g_i-g_j)(p_i-p_j)^T over the edges (i, j) with rest
    vectors gd [E,3] and current ones pd [E,3], into nv rows. A rest edge
    not longer than ``tie`` (two coincident template vertices, moved apart
    by rounding) has no direction, only noise, and its sliver's cotangent
    weight can be 1e5: it adds nothing."""
    w = torch.where((gd * gd).sum(-1) > tie * tie, w, torch.zeros_like(w))
    contrib = w[:, None, None] * gd[:, :, None] * pd[:, None, :]
    S = torch.zeros((nv, 3, 3), dtype=gd.dtype, device=gd.device)
    return S.index_add_(0, i, contrib).index_add_(0, j, contrib)


def _fit_rotations(p, q, i, j, w):
    """Per-vertex rotation best aligning rest edge vectors to current ones:
    R_i = argmax tr(R S_i) (``rotation_covariances``, with the stable_knn
    tie bound)."""
    S = rotation_covariances(p[i] - p[j], q[i] - q[j], w,
                             TIE_REL * p.abs().amax(), p.shape[0], i, j)
    return fit_rotation(S)


def _dot(a, b):
    return (a * b).sum()


def _cg(matvec, b, x0, iters: int, tol: float, precond, dot=_dot):
    """Preconditioned CG for ``iters`` iterations. An iteration that starts
    with ||r|| <= tol, and every one after it, leaves the state unchanged
    (``torch.where`` on a device flag): the values of an early exit, with
    no host read inside the loop. ``dot``: the inner product (a sum over
    every rank's block, for vertex-sharded state)."""
    x = x0
    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = dot(r, z)
    active = torch.ones((), dtype=torch.bool, device=b.device)
    for _ in range(iters):
        active = active & (torch.sqrt(dot(r, r)) > tol)
        Ap = matvec(p)
        alpha = rz / dot(p, Ap).clamp_min(1e-20)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = precond(r_n)
        rz_n = dot(r_n, z_n)
        beta = rz_n / rz.clamp_min(1e-20)
        p_n = z_n + beta * p
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        rz = torch.where(active, rz_n, rz)
    return x


def arap_solve(prob: ARAPProblem, *, outer_iters: int = 5,
               cg_iters: int = 200, tol: float = 1e-4,
               dense: Optional[bool] = None):
    """ARAP local-global iterations (the CGAL deform(5, 1e-4) equivalent,
    Deformation.cpp:393-398): constrained vertices pinned to their targets,
    free vertices solved from the rotation-augmented Poisson system.

    ``dense`` (default: V <= 4096) solves the global step directly: the
    free-masked Laplacian is the same in every outer iteration, so it is
    Cholesky-factorised once per solve (with identity rows on constrained
    vertices and a 1e-6 * mean(degree) jitter on the free diagonal), and
    each outer iteration is one ``cholesky_solve`` — CGAL's own
    preprocess()-then-deform strategy. Above that size the edge-scatter CG
    keeps memory O(E)."""
    rest = prob.rest
    nv = rest.shape[0]
    free = ~prob.constrained
    i, j = prob.edges[:, 0].long(), prob.edges[:, 1].long()
    w = prob.weights
    if dense is None:
        dense = nv <= 4096

    deg = torch.zeros(nv, dtype=rest.dtype, device=rest.device)
    deg.index_add_(0, i, w).index_add_(0, j, w)

    if dense:
        fm = free.to(rest.dtype)
        Ld = torch.zeros((nv, nv), dtype=rest.dtype, device=rest.device)
        Ld.index_put_((i, j), -w, accumulate=True)
        Ld.index_put_((j, i), -w, accumulate=True)
        Ld.diagonal().add_(deg)
        A = Ld * (fm[:, None] * fm[None, :])
        A.diagonal().add_((1.0 - fm) + fm * (1e-6 * deg.mean()))
        chol = torch.linalg.cholesky(A)

        def global_solve(b, p):
            return torch.cholesky_solve(torch.where(free[:, None], b, p),
                                        chol)
    else:
        dinv = torch.where(free, 1.0 / deg.clamp_min(1e-9),
                           torch.ones_like(deg))

        def mv(x):
            y = _laplacian_matvec(torch.where(free[:, None], x,
                                              torch.zeros_like(x)), i, j, w)
            return torch.where(free[:, None], y, torch.zeros_like(y))

        def global_solve(b, p):
            x0 = torch.where(free[:, None], p, torch.zeros_like(p))
            x = _cg(mv, b, x0, cg_iters, tol, lambda r: dinv[:, None] * r)
            count("deform.cg_iterations", cg_iters)
            return torch.where(free[:, None], x, p)

    p = torch.where(prob.constrained[:, None], prob.targets, rest)
    gd = rest[i] - rest[j]
    count("deform.arap_iterations", outer_iters)
    for _ in range(outer_iters):
        R = _fit_rotations(rest, p, i, j, w)
        # rhs_i = sum_j w/2 (R_i + R_j)(g_i - g_j)
        Rij = 0.5 * (R[i] + R[j])
        rot_gd = w[:, None] * (Rij * gd[:, None, :]).sum(-1)
        b = _scatter_edges(nv, i, j, rot_gd)
        # move the constrained vertices' contribution to the rhs
        b = b - _laplacian_matvec(torch.where(
            prob.constrained[:, None], p, torch.zeros_like(p)), i, j, w)
        b = torch.where(free[:, None], b, torch.zeros_like(b))
        p = global_solve(b, p)
    return p


# ---------------------------------------------------------------------------
# full pipeline wrapper (the reference's Deformation class)
# ---------------------------------------------------------------------------

def fit_normals(vertices, faces):
    """Vertex normals for the fit (ops/mesh_normals.vertex_normals) without
    the slivers: faces whose height over their longest edge is under the
    tie bound. The cross product of a zero-area face (two coincident
    corners) is rounding noise, and its unit normal would turn the normals
    that the correspondence search's facing test reads."""
    from ..ops.mesh_normals import vertex_normals
    f = faces.long()
    p0, p1, p2 = vertices[f[:, 0]], vertices[f[:, 1]], vertices[f[:, 2]]
    area2 = torch.linalg.norm(torch.linalg.cross(p1 - p0, p2 - p0, dim=-1),
                              dim=-1)
    longest = torch.stack([torch.linalg.norm(e, dim=-1)
                           for e in (p1 - p0, p2 - p1, p0 - p2)]).amax(0)
    sound = area2 > TIE_REL * vertices.abs().amax() * longest
    return vertex_normals(vertices, faces, sound)


@dataclass
class Deformer:
    """Mirror of the reference Deformation object lifecycle: construct with
    a mesh (tensors on one device; ``normals`` None computes them), call
    deform(scan_points, scan_normals, ...) repeatedly; the deformed geometry
    becomes the new rest state (overwrite_initial_geometry,
    Deformation.cpp:399). Controls, edges and cotangent weights come from
    the initial geometry, on the host (span ``deform.setup``; counter
    ``deform.controls``). A pass runs in the spans
    ``deform.correspondences`` (the control graph, the target search and
    the smoothing), ``deform.arap`` and ``deform.normals``."""
    vertices: torch.Tensor
    faces: torch.Tensor
    normals: Optional[torch.Tensor] = None
    sample_idx: Optional[np.ndarray] = None

    def __post_init__(self):
        with span("deform.setup"):
            self._setup()
        count("deform.controls", len(self.sample_idx))

    def _setup(self):
        if self.normals is None:
            self.normals = fit_normals(self.vertices, self.faces)
        v = self.vertices.cpu().numpy()
        f = self.faces.cpu().numpy()
        if self.sample_idx is None:
            self.sample_idx = uniform_sampling(v)
        edges = mesh_edges(f)
        dev = self.vertices.device
        self._edges = torch.as_tensor(edges, dtype=torch.int64, device=dev)
        self._weights = torch.as_tensor(cotangent_weights(v, f, edges),
                                        device=dev)
        self._sidx = torch.as_tensor(self.sample_idx, device=dev)
        self._constrained = torch.zeros(len(v), dtype=torch.bool,
                                        device=dev)
        self._constrained[self._sidx] = True

    def deform(self, tpts, tnormals, proj_len_err: float = 100.0,
               proj_dist_err: float = 100.0, outer_iters: int = 5):
        """One full Deform() pass (Deformation.cpp:232-401) toward scan
        points / normals [T,3]. Returns and stores the deformed vertices."""
        with span("deform.correspondences"):
            controls = self.vertices[self._sidx]
            nbr_idx, nbr_w = knn_graph(controls.cpu().numpy(), 8)
            corr = find_correspondences(
                controls, self.normals[self._sidx], tpts, tnormals,
                proj_len_err=proj_len_err, proj_dist_err=proj_dist_err)
            dev = controls.device
            smoothed = smooth_displacements(
                corr.targets, controls, torch.as_tensor(nbr_idx, device=dev),
                torch.as_tensor(nbr_w, device=dev))
            targets = self.vertices.clone()
            targets[self._sidx] = smoothed
        with span("deform.arap"):
            prob = ARAPProblem(self.vertices, self._edges, self._weights,
                               self._constrained, targets)
            self.vertices = arap_solve(prob, outer_iters=outer_iters)
        # recompute normals for the next pass (exportOBJ also recomputes,
        # Deformation.h:174-221)
        with span("deform.normals"):
            self.normals = fit_normals(self.vertices, self.faces)
        return self.vertices
