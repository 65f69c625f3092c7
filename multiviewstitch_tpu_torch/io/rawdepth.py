"""Raw disparity-map IO.

The port's own copy of ``multiviewstitch_tpu/io/rawdepth.py`` (numpy only).

The reference stores depth as flat little-endian float32 *disparity* (1/z)
rasters with no header: ``DATA/_depth%d.raw`` (LoadDepth/SaveDepth,
Common/Utils.h:166-186). Width/height come from the camera intrinsics.
"""

from __future__ import annotations

import numpy as np


def load_depth_raw(path: str, width: int, height: int) -> np.ndarray:
    """Read a raw float32 disparity raster -> [H,W] float32."""
    data = np.fromfile(path, dtype=np.float32, count=width * height)
    if data.size != width * height:
        raise ValueError(
            f"{path}: expected {width*height} floats, got {data.size}")
    return data.reshape(height, width)


def save_depth_raw(path: str, disparity: np.ndarray):
    """Write [H,W] disparity as raw float32 (SaveDepth, Common/Utils.h:177-186)."""
    np.asarray(disparity, np.float32).tofile(path)


def depth_to_image(disparity: np.ndarray) -> np.ndarray:
    """Grayscale visualization of a disparity map -> uint8 [H,W].

    Equivalent of RenderDepthMap (Common/Utils.h:189-217): min-max normalize
    the valid (non-zero) disparities to 0..255.
    """
    d = np.asarray(disparity, np.float64)
    valid = d > 0
    if not valid.any():
        return np.zeros(d.shape, np.uint8)
    lo, hi = d[valid].min(), d[valid].max()
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    img = np.where(valid, (d - lo) * scale, 0.0)
    return np.clip(img, 0, 255).astype(np.uint8)
