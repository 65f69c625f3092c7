"""Frozen copies of the scene fixtures the benchmark generates its inputs
with: a bumpy UV sphere, rings of cameras, rendering a mesh (optionally
moved by a similarity) into them, view-consistent textures and the RGB-D
sensor-noise model.

The formulas are those of the port's ``pipeline/fixtures.py`` (itself held
to the JAX package's fixtures) as of this benchmark's first version; they
are copied so that a later change of the port cannot change the inputs.
The noise draws come from a ``torch.Generator`` on the scene's device;
``apply_sensor_noise`` takes them as arguments, so a test can hand it the
port's numpy draws. A full ring of cameras may start at ``phase_deg``.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import Cams, Sim, pixel_grid, unproject_madd
from .raster import render


def uv_sphere(n_lat: int, n_lon: int, radius: float = 0.5,
              bumps: float = 0.0):
    """(verts [V,3] float32, faces [F,3] int32) of a UV sphere with
    low-frequency radial bumps; the poles are open."""
    lat = np.linspace(0, np.pi, n_lat + 2)[1:-1]
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    r = np.full_like(th, radius)
    if bumps > 0:
        r = r * (1.0 + bumps * (np.sin(3 * th) * np.cos(4 * ph) +
                                0.5 * np.sin(5 * ph + 1.0)))
    verts = np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                      r * np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    i = np.arange(n_lat - 1)[:, None]
    j = np.arange(n_lon)[None, :]
    j2 = (j + 1) % n_lon
    a, b = i * n_lon + j, i * n_lon + j2
    c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + j2
    faces = np.stack([np.stack([a, c, d], -1), np.stack([a, d, b], -1)],
                     axis=2).reshape(-1, 3)
    return verts.astype(np.float32), faces.astype(np.int32)


def ring_cameras(n: int, *, radius: float, width: int, height: int,
                 focal: float, look_at=(0.0, 0.0, 0.0), cam_height=0.0,
                 arc_deg: float = 360.0, arc_center_deg: float = 0.0,
                 phase_deg: float = 0.0, device) -> Cams:
    """n cameras on a circle of ``radius`` in the y = cam_height plane (a
    partial arc of ``arc_deg`` centred at ``arc_center_deg``, or a full
    ring starting at ``phase_deg``), all looking at ``look_at``."""
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = focal
    K[:, 0, 2] = (width - 1) / 2.0
    K[:, 1, 2] = (height - 1) / 2.0
    K[:, 2, 2] = 1.0
    Rs, ts = [], []
    tgt = np.asarray(look_at, np.float64)
    for i in range(n):
        if arc_deg >= 360.0:
            ang = 2 * np.pi * i / max(n, 1) + np.radians(phase_deg)
        else:
            step = np.radians(arc_deg) / max(n - 1, 1)
            ang = (i - (n - 1) / 2) * step + np.radians(arc_center_deg)
        center = np.array([radius * np.cos(ang), cam_height,
                           radius * np.sin(ang)])
        fwd = (tgt - center) / np.linalg.norm(tgt - center)
        right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        Rs.append(R)
        ts.append(-R @ center)
    f32 = dict(dtype=torch.float32, device=device)
    return Cams(torch.as_tensor(K, **f32),
                torch.as_tensor(np.stack(Rs), **f32),
                torch.as_tensor(np.stack(ts), **f32), width, height)


def move_scene(verts: np.ndarray, cams: Cams, sim: Sim):
    """The mesh and the cameras mapped through ``sim``:
    (verts', cams') with p'_c = s p_c."""
    s, Rt, tt = np.float64(sim.s), sim.R, sim.t
    verts = (s * (Rt @ verts.T).T + tt).astype(np.float32)
    Rc = cams.R.cpu().numpy().astype(np.float64)
    tc = cams.t.cpu().numpy().astype(np.float64)
    Rc2 = np.einsum("nij,kj->nik", Rc, Rt)
    tc2 = s * tc - np.einsum("nij,j->ni", Rc2, tt)
    f32 = dict(dtype=torch.float32, device=cams.K.device)
    return verts, Cams(cams.K, torch.as_tensor(Rc2, **f32),
                       torch.as_tensor(tc2, **f32), cams.width, cams.height)


def render_mesh(verts: np.ndarray, faces: np.ndarray, cams: Cams):
    """Disparity [N,H,W] of a numpy mesh in ``cams``, on their device."""
    dev = cams.K.device
    return render(torch.as_tensor(verts, device=dev),
                  torch.as_tensor(faces, device=dev), cams)


def textured_views(cams: Cams, disparity, to_object: Sim | None = None):
    """View-consistent 'photos' [N,H,W] (0..255): the albedo is a
    procedural function of the object-space surface point (world points
    mapped through ``to_object``)."""
    n, h, w = disparity.shape
    valid = (disparity >= 1e-6) & (disparity <= 1e6)
    depth = 1.0 / torch.where(valid, disparity, torch.ones_like(disparity))
    uv = pixel_grid(h, w, device=disparity.device)
    pts = unproject_madd(cams.K[:, None, None], cams.R[:, None, None],
                         cams.t[:, None, None], uv, depth)
    p = torch.where(valid[..., None], pts, torch.zeros_like(pts))
    p = p.reshape(-1, 3)
    if to_object is not None:
        inv = to_object
        R = torch.as_tensor(inv.R, dtype=torch.float32, device=p.device)
        p = (torch.tensor(inv.s, dtype=torch.float32, device=p.device) *
             torch.einsum("ij,...j->...i", R, p) +
             torch.as_tensor(inv.t, dtype=torch.float32, device=p.device))
    a = (0.5 + 0.22 * torch.sin(23.0 * p[:, 0]) * torch.cos(17.0 * p[:, 1])
         + 0.18 * torch.sin(31.0 * p[:, 2] + 1.3)
         + 0.10 * torch.sin(57.0 * (p[:, 0] + p[:, 1] + p[:, 2])))
    img = torch.where(valid.reshape(-1), a * 255.0, torch.zeros_like(a))
    return img.reshape(n, h, w).to(torch.float32)


def draw_sensor_noise(shape, gen: torch.Generator):
    """The random numbers of ``apply_sensor_noise`` for [N,H,W] frames,
    in a few large calls on the generator's device."""
    n = shape[0]
    dev = gen.device
    u = torch.rand((2, n), generator=gen, device=dev, dtype=torch.float64)
    g = torch.randn((2,) + tuple(shape), generator=gen, device=dev)
    return dict(gain=u[0] * 0.16 - 0.08, offset=u[1] * 8.0 - 4.0,
                pixel=g[0], depth=g[1],
                drop=torch.rand(tuple(shape), generator=gen, device=dev))


def apply_sensor_noise(gray, disparity, level: float, draws,
                       depth: bool = True):
    """A hand-held consumer RGB-D sensor at strength ``level`` (1 = the
    reference's operating regime): per-frame gain and offset drift,
    vignetting and pixel noise on the gray image; with ``depth``, 1 %·level
    multiplicative disparity noise, quantisation to 0.5 %·level of the mean
    disparity and 0.5 %·level dropouts. Returns float32 (gray,
    disparity)."""
    if level <= 0:
        return gray.float(), disparity.float()
    n, h, w = gray.shape
    dev = gray.device
    gain = 1.0 + draws["gain"].double().view(n, 1, 1) * level
    offset = draws["offset"].double().view(n, 1, 1) * level
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    r2 = (((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2) / 2
    vig = 1.0 - 0.2 * level * r2[None]
    g = (gray.float().double() * gain * vig.double() + offset +
         (draws["pixel"].float() * 2.5 * level).double())
    g = g.clamp(0.0, 255.0).float()
    if not depth:
        return g, disparity.float()
    valid = disparity > 0
    d = disparity.float() * (1.0 + draws["depth"].float() * 0.01 * level)
    q = 0.005 * level * float(d[valid].mean()) if bool(valid.any()) else 0.0
    if q > 0:
        d = torch.round(d / q) * q
    drop = draws["drop"] < 0.005 * level
    d = torch.where(valid & ~drop, d, torch.zeros_like(d)).float()
    return g, d
