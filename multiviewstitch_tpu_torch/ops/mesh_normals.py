"""Facet and vertex normals as scatter-adds over the face list.

PyTorch counterpart of ``multiviewstitch_tpu/ops/mesh_normals.py``
(Mesh::CalFacetNormal / CalVtxNormal, PlyObj.cpp:139-243): the reference
averages the unit facet normals adjacent to each vertex, unweighted by
area. Here that is three ``index_add_`` passes over the faces.
"""

from __future__ import annotations

import torch


def facet_normals(vertices, faces, normalize: bool = True):
    """Per-face normals [F,3] from cross products (PlyObj.cpp:139-168)."""
    f = faces.long()
    p0, p1, p2 = vertices[f[:, 0]], vertices[f[:, 1]], vertices[f[:, 2]]
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    if normalize:
        n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    return n


def vertex_normals(vertices, faces, face_mask=None, *, num_vertices=None):
    """Unweighted average of the adjacent unit facet normals per vertex
    (PlyObj.cpp:170-243), normalised. Faces may be padded: ``face_mask``
    [F] excludes rows, and face ids outside 0..num_vertices-1 are dropped
    (the JAX scatter's mode="drop")."""
    nv = num_vertices or vertices.shape[0]
    fn = facet_normals(vertices, faces)
    one = torch.ones(faces.shape[0], dtype=vertices.dtype,
                     device=vertices.device)
    if face_mask is not None:
        fn = torch.where(face_mask[:, None], fn, torch.zeros_like(fn))
        one = torch.where(face_mask, one, torch.zeros_like(one))
    acc = torch.zeros((nv, 3), dtype=vertices.dtype, device=vertices.device)
    cnt = torch.zeros((nv,), dtype=vertices.dtype, device=vertices.device)
    for k in range(3):
        idx = faces[:, k].long()
        keep = (idx >= 0) & (idx < nv)
        idx = torch.where(keep, idx, torch.zeros_like(idx))
        acc.index_add_(0, idx, torch.where(keep[:, None], fn,
                                           torch.zeros_like(fn)))
        cnt.index_add_(0, idx, torch.where(keep, one, torch.zeros_like(one)))
    n = acc / cnt[:, None].clamp_min(1.0)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
