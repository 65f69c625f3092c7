"""Depth-map -> grid mesh extraction (the reference's Depth2Model).

PyTorch counterpart of ``multiviewstitch_tpu/ops/meshing.py``, a redesign
of Depth2Model::SaveModel (Depth2Model.cpp:7-107): the reference scans
pixels serially, numbering valid ones (row-major ``tab``) and emitting up to
two triangles per quad when the three corner disparity deltas are below
``smooth_thres*(max_dsp-min_dsp)/100``. Here vertex ids come from a cumsum
over the validity mask, triangles from vectorised quad-corner tests, and
both lists from boolean compaction (no static capacities).

Vertex order (row-major over valid pixels) and triangle order (per quad
row-major: tri1 (v00,v10,v11), then tri2 (v00,v11,v01)) match the
reference, so OBJ artifacts diff cleanly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.cameras import CameraBatch, pixel_grid, unproject


class GridMesh(NamedTuple):
    """A compact mesh on the disparity's device."""
    vertices: torch.Tensor    # [V,3] f32
    tex_index: torch.Tensor   # [V] int64 source pixel (v*W+u)
    faces: torch.Tensor       # [F,3] int64 vertex ids
    num_vertices: int
    num_faces: int


def grid_mesh(disparity: torch.Tensor, cam: CameraBatch, *, min_dsp: float,
              max_dsp: float, smooth_thres: float,
              edge_sz_thres: float = 0.0) -> GridMesh:
    """Mesh of one [H,W] disparity map seen by the single camera ``cam``.
    ``edge_sz_thres`` > 0 also drops triangles with a 3D edge longer than
    it."""
    h, w = disparity.shape
    d = disparity
    # validity: disparity > 0 and inside range (Depth2Model.cpp:31-33)
    valid = (d > 0) & (d >= min_dsp) & (d <= max_dsp)
    flat_valid = valid.reshape(-1)
    ids = torch.cumsum(flat_valid.to(torch.int64), 0) - 1   # reference tab-1

    uv = pixel_grid(h, w, d.dtype, device=d.device)
    depth = 1.0 / torch.where(valid, d, torch.ones_like(d))
    P = unproject(cam, uv, depth)                           # [H,W,3]
    tex_index = flat_valid.nonzero()[:, 0]
    vertices = P.reshape(-1, 3)[tex_index]

    # quad tests (Depth2Model.cpp:45-77), on raw disparity deltas
    thr = smooth_thres * (max_dsp - min_dsp) / 100.0
    d00, d10, d01, d11 = d[:-1, :-1], d[1:, :-1], d[:-1, 1:], d[1:, 1:]
    v00, v10, v01, v11 = (valid[:-1, :-1], valid[1:, :-1], valid[:-1, 1:],
                          valid[1:, 1:])
    tri1 = (v00 & v11 & v10 & ((d00 - d10).abs() <= thr) &
            ((d11 - d10).abs() <= thr) & ((d00 - d11).abs() <= thr))
    tri2 = (v00 & v11 & v01 & ((d00 - d01).abs() <= thr) &
            ((d11 - d01).abs() <= thr) & ((d11 - d00).abs() <= thr))
    if edge_sz_thres and edge_sz_thres > 0:
        # EdgeSzThres (GeometryRec.cpp:30-39): reject triangles with any 3D
        # edge longer than the threshold
        p00, p10, p01, p11 = P[:-1, :-1], P[1:, :-1], P[:-1, 1:], P[1:, 1:]

        def short(a, b):
            return ((a - b) ** 2).sum(-1) <= edge_sz_thres ** 2

        tri1 = tri1 & short(p00, p10) & short(p10, p11) & short(p00, p11)
        tri2 = tri2 & short(p00, p11) & short(p11, p01) & short(p00, p01)

    id2 = ids.reshape(h, w)
    i00, i10, i01, i11 = id2[:-1, :-1], id2[1:, :-1], id2[:-1, 1:], id2[1:, 1:]
    tri_mask = torch.stack([tri1, tri2], -1).reshape(-1)
    tri_ids = torch.stack([torch.stack([i00, i10, i11], -1),
                           torch.stack([i00, i11, i01], -1)], -2)
    faces = tri_ids.reshape(-1, 3)[tri_mask]
    return GridMesh(vertices, tex_index, faces, int(tex_index.shape[0]),
                    int(faces.shape[0]))


def compact_mesh(m: GridMesh):
    """Host copy: (verts [V,3] f32, faces [F,3] int32, tex [V] int32)
    numpy."""
    import numpy as np
    return (m.vertices.cpu().numpy(), m.faces.cpu().numpy().astype(np.int32),
            m.tex_index.cpu().numpy().astype(np.int32))
