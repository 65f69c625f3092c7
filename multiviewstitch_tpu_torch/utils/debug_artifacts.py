"""Debug artifact dumps, gated by ``StitchConfig.debug_artifacts``.

A copy of ``multiviewstitch_tpu/utils/debug_artifacts.py`` (numpy and PIL
only). The reference's de-facto test method is visual artifact dumping (SURVEY §4):
match visualizations ``Match/match%d_%d_%d.jpg`` + imshow
(Processor.cpp:767-793), SIFT keypoint overlays (FeatureProc.cpp:67-74),
grayscale depth maps (Common/Utils.h:189-217), intermediate meshes
(Alignment.cpp:139-145, 221-231; Deformation.cpp:105). This module writes
the same artifacts (PNG via PIL when available, else .npy; OBJ always)
behind one switch, so pipeline runs are inspectable without a debugger.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _save_image(path: str, img: np.ndarray):
    """img: [H,W] float/uint8 or [H,W,3]. PNG with PIL, .npy fallback."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        lo, hi = float(arr.min()), float(arr.max())
        arr = ((arr - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8)
    try:
        from PIL import Image
        Image.fromarray(arr).save(path)
    except ImportError:
        np.save(os.path.splitext(path)[0] + ".npy", arr)


def save_depth_image(path: str, disparity: np.ndarray):
    """Grayscale disparity visualization (RenderDepthMap equivalent)."""
    from ..io.rawdepth import depth_to_image
    _save_image(path, depth_to_image(np.asarray(disparity)))


def save_keypoint_overlay(path: str, gray: np.ndarray, uv: np.ndarray,
                          valid: Optional[np.ndarray] = None,
                          radius: int = 1):
    """Keypoints as bright crosses on the image (FeatureProc.cpp:67-74)."""
    img = np.asarray(gray, np.float32).copy()
    lo, hi = img.min(), img.max()
    img = (img - lo) / (hi - lo + 1e-12)
    rgb = np.stack([img, img, img], -1)
    h, w = img.shape
    pts = np.asarray(uv)
    if valid is not None:
        pts = pts[np.asarray(valid)]
    for u, v in pts.astype(int):
        for d in range(-radius, radius + 1):
            if 0 <= v < h and 0 <= u + d < w:
                rgb[v, u + d] = [1.0, 0.1, 0.1]
            if 0 <= v + d < h and 0 <= u < w:
                rgb[v + d, u] = [1.0, 0.1, 0.1]
    _save_image(path, rgb)


def save_match_visualization(path: str, gray1: np.ndarray, gray2: np.ndarray,
                             uv1: np.ndarray, uv2: np.ndarray,
                             mask: Optional[np.ndarray] = None):
    """Side-by-side images with colored match lines
    (Processor.cpp:767-793)."""
    g1 = np.asarray(gray1, np.float32)
    g2 = np.asarray(gray2, np.float32)
    h = max(g1.shape[0], g2.shape[0])
    w1, w2 = g1.shape[1], g2.shape[1]

    def norm(g):
        return (g - g.min()) / (g.max() - g.min() + 1e-12)

    canvas = np.zeros((h, w1 + w2, 3), np.float32)
    canvas[:g1.shape[0], :w1] = norm(g1)[..., None]
    canvas[:g2.shape[0], w1:] = norm(g2)[..., None]

    p1 = np.asarray(uv1)
    p2 = np.asarray(uv2)
    if mask is not None:
        m = np.asarray(mask)
        p1, p2 = p1[m], p2[m]
    rng = np.random.default_rng(0)
    for (u1, v1), (u2, v2) in zip(p1.astype(int), p2.astype(int)):
        color = rng.uniform(0.3, 1.0, 3)
        # Bresenham-lite line
        x2 = u2 + w1
        steps = max(abs(x2 - u1), abs(v2 - v1), 1)
        for s in range(steps + 1):
            x = int(u1 + (x2 - u1) * s / steps)
            y = int(v1 + (v2 - v1) * s / steps)
            if 0 <= y < h and 0 <= x < w1 + w2:
                canvas[y, x] = color
    _save_image(path, canvas)


def save_mesh(path: str, vertices, normals=None, faces=None):
    from ..io.meshio import write_obj
    write_obj(path, np.asarray(vertices),
              None if normals is None else np.asarray(normals),
              None if faces is None else np.asarray(faces))


def save_labeled_points(path: str, points, labels):
    from ..models.parts import visualize_parts
    visualize_parts(path, np.asarray(points), np.asarray(labels))
