"""K3, the tile-binned rasterizer (``csrc/raster.cu``): setup and tile
counts, scan, scatter into bins, the fine pass; one call per sequence in
``render``, on the model's projected vertices."""

from __future__ import annotations

import torch

from . import least_seconds

KERNELS = (r"^(void )?\(anonymous namespace\)::"
           r"(bin_kernel|scan_kernel|fine_kernel)\b")
CALLS = r"^(void )?\(anonymous namespace\)::scan_kernel\b"


def bound(uvz, faces, face_ok, height: int, width: int) -> float:
    """Reads the projected vertices uvz [N,V,3], faces [F,3] (int32) and
    the face mask [N,F] and writes the z-buffer [N,H,W]; ~40 flops a live
    face (setup) and ~15 a pixel of its image-clipped bbox (three edge
    functions)."""
    n = uvz.shape[0]
    fl = faces.long()
    ua, va = uvz[..., 0][:, fl], uvz[..., 1][:, fl]
    area = ((ua[..., 1] - ua[..., 0]) * (va[..., 2] - va[..., 0]) -
            (va[..., 1] - va[..., 0]) * (ua[..., 2] - ua[..., 0]))
    x0 = ua.min(-1).values.floor().clamp_min(0.0)
    x1 = ua.max(-1).values.ceil().clamp_max(width - 1.0)
    y0 = va.min(-1).values.floor().clamp_min(0.0)
    y1 = va.max(-1).values.ceil().clamp_max(height - 1.0)
    live = face_ok & (area.abs() > 1e-12) & (x0 <= x1) & (y0 <= y1)
    px = torch.where(live, (x1 - x0 + 1) * (y1 - y0 + 1),
                     torch.zeros_like(x0))
    n_bytes = (uvz.numel() * 4 + faces.numel() * 4 + face_ok.numel() +
               n * height * width * 4)
    return least_seconds(n_bytes, 40 * int(live.sum()) + 15 * float(px.sum()))
