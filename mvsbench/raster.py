"""Plain depth rasterizer of the benchmark (torch only, any device).

Projects a mesh through each camera and z-maxes every face into a
disparity image (largest 1/z wins, 0 = no hit), with 1/z interpolated
linearly in screen space. A frozen copy of the semantics of the port's
plain rasterizer: the scenes are drawn by it, so the inputs never pass
through the port's kernel, and the reference draws the port's re-render
again with it.
"""

from __future__ import annotations

import torch

from .geometry import Cams, Mat, rot_madd

ZNEAR = 1e-4        # faces with a vertex at z <= ZNEAR are culled


def project_vertices(vertices, faces, cams: Cams, mat: Mat | None = None):
    """(uvz [N,V,3] = (u, v, 1/z), face_ok [N,F]). Without ``mat`` the
    fixtures' multiply-add form, with it the reference's matrix form."""
    K = cams.K[:, None]
    if mat is None:
        pc = rot_madd(cams.R[:, None], vertices) + cams.t[:, None]
    else:
        pc = mat.world_to_cam(cams.R[:, None], cams.t[:, None], vertices)
    z = pc[..., 2]
    zsafe = torch.where(z.abs() < ZNEAR, torch.full_like(z, ZNEAR), z)
    if mat is None:
        u = K[..., 0, 0] * pc[..., 0] / zsafe + K[..., 0, 2]
        v = K[..., 1, 1] * pc[..., 1] / zsafe + K[..., 1, 2]
    else:
        q = mat.mv(K, pc)
        u = q[..., 0] / zsafe
        v = q[..., 1] / zsafe
    invz = torch.where(z > ZNEAR, 1.0 / zsafe, torch.zeros_like(z))
    uvz = torch.stack([u, v, invz], -1)
    ok = (z[:, faces.long()] > ZNEAR).all(-1)
    return uvz, ok


def raster(uvz, faces, face_ok, *, height: int, width: int):
    """Every (face, pixel) pair of each face's image-clipped bbox
    [floor(min), ceil(max)] is tested with three edge functions and
    z-maxed. uvz [N,V,3], faces [F,3], face_ok [N,F] -> [N,H,W]."""
    n = uvz.shape[0]
    dev = uvz.device
    fl = faces.long()
    zbuf = torch.zeros((n, height * width), dtype=torch.float32, device=dev)
    for i in range(n):
        ua, va, za = (uvz[i, :, k][fl] for k in range(3))      # [F,3]
        area = ((ua[:, 1] - ua[:, 0]) * (va[:, 2] - va[:, 0]) -
                (va[:, 1] - va[:, 0]) * (ua[:, 2] - ua[:, 0]))
        x0 = ua.min(-1).values.floor().clamp_min(0.0)
        x1 = ua.max(-1).values.ceil().clamp_max(width - 1.0)
        y0 = va.min(-1).values.floor().clamp_min(0.0)
        y1 = va.max(-1).values.ceil().clamp_max(height - 1.0)
        live = face_ok[i] & (area.abs() > 1e-12) & (x0 <= x1) & (y0 <= y1)
        sel = live.nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        bw = (x1[sel] - x0[sel]).long() + 1
        cnt = bw * ((y1[sel] - y0[sel]).long() + 1)
        fid = torch.repeat_interleave(sel, cnt)
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
        disp = (e1 / a) * za[fid, 0] + (e2 / a) * za[fid, 1] + \
            (e0 / a) * za[fid, 2]
        hit = inside & (disp > 0)
        idx = (py.long() * width + px.long())[hit]
        zbuf[i].scatter_reduce_(0, idx, disp[hit], reduce="amax",
                                include_self=True)
    return zbuf.reshape(n, height, width)


def render(vertices, faces, cams: Cams, mat: Mat | None = None):
    """Disparity [N,H,W] of the mesh in every camera."""
    uvz, ok = project_vertices(vertices, faces, cams, mat)
    return raster(uvz, faces, ok, height=cams.height, width=cams.width)
