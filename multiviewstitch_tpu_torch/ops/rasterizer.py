"""Depth rasterizer (the reference's Model2Depth, GL-free).

PyTorch counterpart of ``multiviewstitch_tpu/ops/rasterizer.py``: project
the mesh through each camera, then z-max (largest 1/z wins) every valid
face into a disparity image, 0 = no hit. Disparity is interpolated linearly
in screen space (exact perspective-correct 1/z).

The JAX package splits faces into size classes (tile passes, a compacted
scatter ladder, a full-frame pass, two Pallas kernels). Here one kernel
(K3, ``csrc/raster.cu``) bins every face into the 16x16 tiles its clipped
pixel bbox touches and z-maxes each tile on chip, so any face size renders
exactly and ``overflow`` is always 0. ``raster_reference`` is its plain
PyTorch version, taken for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..core.cameras import CameraBatch, world_to_cam


ZNEAR = 1e-4   # near plane: faces with a vertex at z <= ZNEAR are culled


class RenderResult(NamedTuple):
    disparity: torch.Tensor   # [H,W] f32, 0 where empty
    overflow: torch.Tensor    # scalar i32: always 0 (every face renders)


def project_vertices(vertices, faces, face_mask, cams: CameraBatch):
    """Per-frame setup: (uvz [N,V,3] = (u, v, 1/z), faces clipped to the
    vertex range [F,3] int32, face_ok [N,F] bool — valid faces with every
    vertex in front of the near plane). ``cams`` has batch [N]."""
    pc = world_to_cam(cams.expand_dims(1), vertices)      # [N,V,3]
    z = pc[..., 2]
    zsafe = torch.where(z.abs() < ZNEAR, torch.full_like(z, ZNEAR), z)
    u = cams.fx[:, None] * pc[..., 0] / zsafe + cams.cx[:, None]
    v = cams.fy[:, None] * pc[..., 1] / zsafe + cams.cy[:, None]
    invz = torch.where(z > ZNEAR, 1.0 / zsafe, torch.zeros_like(z))
    uvz = torch.stack([u, v, invz], dim=-1).contiguous()
    f = faces.clamp(0, vertices.shape[0] - 1).to(torch.int32).contiguous()
    zs = z[:, f.long()]                                   # [N,F,3]
    ok = face_mask[None] & (zs > ZNEAR).all(dim=-1)
    return uvz, f, ok.contiguous()


def clipped_bboxes(ua, va, face_ok, *, height: int, width: int):
    """K3's cull and bbox rule for faces with corner coordinates ua, va
    [...,3]: (signed area, x0, x1, y0, y1, live). The bbox is the
    image-clipped [floor(min), ceil(max)] (float pixel indices); live faces
    have face_ok, |area| > 1e-12 and a non-empty clipped bbox."""
    area = ((ua[..., 1] - ua[..., 0]) * (va[..., 2] - va[..., 0]) -
            (va[..., 1] - va[..., 0]) * (ua[..., 2] - ua[..., 0]))
    x0 = ua.min(-1).values.floor().clamp_min(0.0)
    x1 = ua.max(-1).values.ceil().clamp_max(width - 1.0)
    y0 = va.min(-1).values.floor().clamp_min(0.0)
    y1 = va.max(-1).values.ceil().clamp_max(height - 1.0)
    live = face_ok & (area.abs() > 1e-12) & (x0 <= x1) & (y0 <= y1)
    return area, x0, x1, y0, y1, live


def raster_reference(uvz, faces, face_ok, *, height: int, width: int):
    """Plain PyTorch version of K3: every (face, pixel) pair of each face's
    image-clipped bbox [floor(min), ceil(max)] is evaluated with the edge
    functions of ``_raster_pass`` and z-maxed with ``scatter_reduce``.
    uvz [N,V,3], faces [F,3], face_ok [N,F] -> [N,height,width]."""
    n = uvz.shape[0]
    dev = uvz.device
    fl = faces.long()
    zbuf = torch.zeros((n, height * width), dtype=torch.float32, device=dev)
    for i in range(n):
        ua = uvz[i, :, 0][fl]                             # [F,3]
        va = uvz[i, :, 1][fl]
        za = uvz[i, :, 2][fl]
        area, x0, x1, y0, y1, live = clipped_bboxes(
            ua, va, face_ok[i], height=height, width=width)
        sel = live.nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        bw = (x1[sel] - x0[sel]).long() + 1
        cnt = bw * ((y1[sel] - y0[sel]).long() + 1)
        fid = torch.repeat_interleave(sel, cnt)           # [P]
        start = torch.cumsum(cnt, 0) - cnt
        p = (torch.arange(int(cnt.sum()), device=dev) -
             torch.repeat_interleave(start, cnt))
        bwp = torch.repeat_interleave(bw, cnt)
        px = x0[fid] + (p % bwp).to(torch.float32)
        py = y0[fid] + torch.div(p, bwp, rounding_mode="floor").to(
            torch.float32)
        u0, u1, u2 = ua[fid, 0], ua[fid, 1], ua[fid, 2]
        v0, v1, v2 = va[fid, 0], va[fid, 1], va[fid, 2]
        e0 = (u1 - u0) * (py - v0) - (v1 - v0) * (px - u0)
        e1 = (u2 - u1) * (py - v1) - (v2 - v1) * (px - u1)
        e2 = (u0 - u2) * (py - v2) - (v0 - v2) * (px - u2)
        a = area[fid]
        inside = torch.where(a >= 0, (e0 >= 0) & (e1 >= 0) & (e2 >= 0),
                             (e0 <= 0) & (e1 <= 0) & (e2 <= 0))
        w0 = e1 / a
        w1 = e2 / a
        w2 = e0 / a
        disp = w0 * za[fid, 0] + w1 * za[fid, 1] + w2 * za[fid, 2]
        hit = inside & (disp > 0)
        idx = (py.long() * width + px.long())[hit]
        zbuf[i].scatter_reduce_(0, idx, disp[hit], reduce="amax",
                                include_self=True)
    return zbuf.reshape(n, height, width)


def raster(uvz, faces, face_ok, *, height: int, width: int):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if uvz.device.type == "cuda":
        return kernels.raster(uvz, faces, face_ok, height=height,
                              width=width)
    if uvz.device.type == "cpu":
        return raster_reference(uvz, faces, face_ok, height=height,
                                width=width)
    raise ValueError(f"raster: unsupported device {uvz.device}")


def render_sequence(vertices, faces, face_mask, cams: CameraBatch, *,
                    height: int, width: int) -> torch.Tensor:
    """Render every frame of a camera batch -> [N,H,W] disparities (one
    kernel launch for all frames)."""
    uvz, f, ok = project_vertices(vertices, faces, face_mask, cams)
    return raster(uvz, f, ok, height=height, width=width)


def render_disparity(vertices, faces, face_mask, cam: CameraBatch, *,
                     height: int, width: int) -> RenderResult:
    """Render one camera -> RenderResult([H,W] disparity, overflow=0)."""
    cams = CameraBatch(cam.K[None], cam.R[None], cam.t[None], cam.width,
                       cam.height)
    d = render_sequence(vertices, faces, face_mask, cams, height=height,
                        width=width)[0]
    return RenderResult(d, torch.zeros((), dtype=torch.int32,
                                       device=d.device))
