"""Synthetic scene fixtures: known mesh + known cameras -> rendered RGB-D.

PyTorch counterpart of ``multiviewstitch_tpu/pipeline/fixtures.py``
(``uv_sphere``, ``ring_cameras``, ``make_scene``, ``textured_views``,
``shade_views``, and the noise models ``sensor_noise`` and
``inject_outlier_matches``). The reference ships no data, so the demo
inputs are disparity maps of a bumpy sphere rendered with the port's own
rasterizer (K3 on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.cameras import CameraBatch, unproject_depth_map
from ..core.transforms import Similarity, apply_points, inverse
from ..ops.mesh_normals import vertex_normals
from ..ops.rasterizer import render_sequence


def uv_sphere(n_lat: int = 24, n_lon: int = 32, radius: float = 0.5,
              bumps: float = 0.0, seed: int = 0):
    """UV-sphere mesh (optionally with low-frequency radial bumps) ->
    (verts [V,3] f32, faces [F,3] i32) as numpy arrays. The mesh is
    deterministic: ``seed`` is taken, as by the JAX fixture, and does not
    change it."""
    lat = np.linspace(0, np.pi, n_lat + 2)[1:-1]
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    r = np.full_like(th, radius)
    if bumps > 0:
        r = r * (1.0 + bumps * (np.sin(3 * th) * np.cos(4 * ph) +
                                0.5 * np.sin(5 * ph + 1.0)))
    x = r * np.sin(th) * np.cos(ph)
    y = r * np.cos(th)
    z = r * np.sin(th) * np.sin(ph)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)

    i = np.arange(n_lat - 1)[:, None]
    j = np.arange(n_lon)[None, :]
    j2 = (j + 1) % n_lon
    a = i * n_lon + j
    b = i * n_lon + j2
    c = (i + 1) * n_lon + j
    d = (i + 1) * n_lon + j2
    faces = np.stack([np.stack([a, c, d], -1), np.stack([a, d, b], -1)],
                     axis=2).reshape(-1, 3)
    return verts, faces.astype(np.int32)


def ring_cameras(n: int, radius: float = 2.0, height: float = 0.0,
                 width: int = 160, length_focal: float = 120.0,
                 img_height: int = 120, look_at=(0.0, 0.0, 0.0),
                 arc_deg: float = 360.0, arc_center_deg: float = 0.0, *,
                 device) -> CameraBatch:
    """n cameras on a circle of ``radius`` (or a partial arc of ``arc_deg``
    centred at ``arc_center_deg``) in the y=height plane, all looking at
    ``look_at``; p_c = R p_w + t. A full ring always starts at angle 0."""
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = length_focal
    K[:, 1, 1] = length_focal
    K[:, 0, 2] = (width - 1) / 2.0
    K[:, 1, 2] = (img_height - 1) / 2.0
    K[:, 2, 2] = 1.0
    Rs, ts = [], []
    tgt = np.asarray(look_at, np.float64)
    for i in range(n):
        if arc_deg >= 360.0:
            ang = 2 * np.pi * i / max(n, 1)
        else:
            step = np.radians(arc_deg) / max(n - 1, 1)
            ang = (i - (n - 1) / 2) * step + np.radians(arc_center_deg)
        center = np.array([radius * np.cos(ang), height,
                           radius * np.sin(ang)])
        fwd = tgt - center
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])
        Rs.append(R)
        ts.append(-R @ center)
    f32 = dict(dtype=torch.float32, device=device)
    return CameraBatch(torch.as_tensor(K, **f32),
                       torch.as_tensor(np.stack(Rs), **f32),
                       torch.as_tensor(np.stack(ts), **f32), width,
                       img_height)


class Scene(NamedTuple):
    vertices: np.ndarray         # [V,3]
    faces: np.ndarray            # [F,3]
    cams: CameraBatch            # N frames
    disparity: torch.Tensor      # [N,H,W] rendered disparity
    gt_transform: Optional[Similarity]


def make_scene(n_frames: int = 4, width: int = 160, height: int = 120,
               cam_radius: float = 2.0, bumps: float = 0.12, seed: int = 0,
               transform: Optional[Similarity] = None,
               n_lat: int = 48, n_lon: int = 64, arc_deg: float = 360.0,
               arc_center_deg: float = 0.0, *, device) -> Scene:
    """Render a bumpy-sphere scene on ``device``. With ``transform``, the
    world (mesh AND cameras) is mapped through it: two scenes of the same
    mesh related by a known similarity."""
    verts, faces = uv_sphere(n_lat, n_lon, bumps=bumps, seed=seed)
    cams = ring_cameras(n_frames, radius=cam_radius, width=width,
                        img_height=height, arc_deg=arc_deg,
                        arc_center_deg=arc_center_deg, device=device)
    return mesh_scene(verts, faces, cams, transform)


def mesh_scene(verts, faces, cams: CameraBatch,
               transform: Optional[Similarity] = None) -> Scene:
    """Render the mesh (numpy verts [V,3], faces [F,3]) into every camera of
    ``cams``, on the cameras' device; with ``transform`` the mesh and the
    cameras are first mapped through it, as in ``make_scene``."""
    device = cams.K.device
    height, width = cams.height, cams.width
    if transform is not None:
        s = np.float64(transform.s.cpu().numpy())
        Rt = transform.R.cpu().numpy().astype(np.float64)
        tt = transform.t.cpu().numpy().astype(np.float64)
        verts = (s * (Rt @ verts.T).T + tt).astype(np.float32)
        Rc = cams.R.cpu().numpy().astype(np.float64)
        tc = cams.t.cpu().numpy().astype(np.float64)
        # p'_c = s * p_c: R'_c = R_c R^T, t'_c = s t_c - R'_c t
        Rc2 = np.einsum("nij,kj->nik", Rc, Rt)
        tc2 = s * tc - np.einsum("nij,j->ni", Rc2, tt)
        f32 = dict(dtype=torch.float32, device=device)
        cams = CameraBatch(cams.K, torch.as_tensor(Rc2, **f32),
                           torch.as_tensor(tc2, **f32), cams.width,
                           cams.height)
    v_t = torch.as_tensor(verts, device=device)
    f_t = torch.as_tensor(faces, device=device)
    fmask = torch.ones(faces.shape[0], dtype=torch.bool, device=device)
    disp = render_sequence(v_t, f_t, fmask, cams, height=height, width=width)
    return Scene(verts, faces, cams, disp, transform)


def textured_views(scene: Scene) -> torch.Tensor:
    """View-consistent 'photos' [N,H,W] (0..255): albedo is a procedural
    function of the OBJECT-space surface point, so the same surface point
    has the same intensity in every view and every transformed copy."""
    pts, valid = unproject_depth_map(scene.cams, scene.disparity, 1e-6, 1e6)
    p = pts.reshape(-1, 3)
    if scene.gt_transform is not None:
        p = apply_points(inverse(scene.gt_transform.to(p.device)), p)
    a = (0.5 + 0.22 * torch.sin(23.0 * p[:, 0]) * torch.cos(17.0 * p[:, 1])
         + 0.18 * torch.sin(31.0 * p[:, 2] + 1.3)
         + 0.10 * torch.sin(57.0 * (p[:, 0] + p[:, 1] + p[:, 2])))
    img = torch.where(valid.reshape(-1), a * 255.0, torch.zeros_like(a))
    return img.reshape(scene.disparity.shape).to(torch.float32)


def sensor_noise(gray: np.ndarray, disparity: np.ndarray, level: float,
                 seed: int = 0):
    """Apply a realistic RGB-D sensor noise model at strength ``level``
    (0 = clean; 1 = a plausible hand-held consumer depth camera, the
    reference's operating regime; its pixel_err/dsp_err/conf_min thresholds
    exist for this). numpy in, numpy out, drawing the JAX fixture's numbers
    from ``np.random.default_rng(seed)``.

    Photometric (gray, 0..255 scale): per-frame gain/offset drift (auto
    exposure), radial vignetting, additive Gaussian pixel noise.
    Geometric (disparity): multiplicative Gaussian noise, then quantization
    to discrete disparity steps (the staircase of real stereo and
    structured-light sensors), plus salt dropouts (invalid pixels).

    Returns (gray_noisy, disparity_noisy) as float32 copies.
    """
    rng = np.random.default_rng(seed)
    n, h, w = gray.shape
    g = gray.astype(np.float32).copy()
    d = disparity.astype(np.float32).copy()
    if level <= 0:
        return g, d

    # photometric: gain in [1-0.08L, 1+0.08L], offset +-4L gray levels,
    # vignette up to 20%*L at the corners, noise sigma 2.5L
    gain = 1.0 + rng.uniform(-0.08, 0.08, size=(n, 1, 1)) * level
    offset = rng.uniform(-4.0, 4.0, size=(n, 1, 1)) * level
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = (((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2) / 2
    vig = 1.0 - 0.2 * level * r2[None]
    g = g * gain * vig + offset + \
        rng.normal(size=g.shape).astype(np.float32) * 2.5 * level
    g = np.clip(g, 0.0, 255.0).astype(np.float32)

    # geometric: 1% * L multiplicative noise, quantize to 0.5% * L steps,
    # 0.5% * L dropouts
    valid = d > 0
    d = d * (1.0 + rng.normal(size=d.shape).astype(np.float32) *
             0.01 * level)
    q = 0.005 * level * float(d[valid].mean()) if valid.any() else 0.0
    if q > 0:
        d = np.round(d / q) * q
    drop = rng.random(d.shape) < 0.005 * level
    d = np.where(valid & ~drop, d, 0.0).astype(np.float32)
    return g, d


def inject_outlier_matches(uv1: np.ndarray, uv2: np.ndarray,
                           mask: np.ndarray, frac: float, width: int,
                           height: int, seed: int = 0):
    """Replace ``frac`` of the valid matches' second endpoints with uniform
    random pixels: synthetic gross outliers for RANSAC and filter-cascade
    robustness tests (the reference's RemoveOutliers rounds exist for
    these, Processor.cpp:196-259). Returns (uv2 with outliers, their
    indices)."""
    rng = np.random.default_rng(seed)
    uv2 = uv2.copy()
    vi = np.flatnonzero(mask)
    n_bad = int(len(vi) * frac)
    bad = rng.choice(vi, size=n_bad, replace=False) if n_bad else \
        np.zeros(0, np.int64)
    uv2[bad, 0] = rng.integers(0, width, size=n_bad)
    uv2[bad, 1] = rng.integers(0, height, size=n_bad)
    return uv2, bad


def shade_views(scene: Scene, light=(0.4, 0.7, 0.2)) -> torch.Tensor:
    """Lambertian grayscale 'photos' [N,H,W] (0.2..1.0 on the surface, 0
    elsewhere) from the scene's disparity maps and mesh: each pixel takes
    the normal of its nearest mesh vertex (exact differences, 4096 pixels
    at a time), on the scene's device."""
    dev = scene.disparity.device
    light = torch.as_tensor(np.asarray(light) / np.linalg.norm(light),
                            dtype=torch.float32, device=dev)
    verts = torch.as_tensor(scene.vertices, device=dev)
    vn = vertex_normals(verts, torch.as_tensor(
        np.asarray(scene.faces, np.int64), device=dev))
    pts, valid = unproject_depth_map(scene.cams, scene.disparity, 1e-6, 1e6)
    p = pts.reshape(-1, 3)
    nearest = torch.cat([((c[:, None, :] - verts[None]) ** 2).sum(-1)
                         .argmin(1) for c in p.split(4096)])
    shade = (vn[nearest] @ light).abs()
    img = torch.where(valid.reshape(-1), 0.2 + 0.8 * shade,
                      torch.zeros_like(shade))
    return img.reshape(scene.disparity.shape)
