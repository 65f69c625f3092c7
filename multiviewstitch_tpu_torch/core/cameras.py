"""Batched pinhole cameras as a small dataclass of tensors.

PyTorch counterpart of ``multiviewstitch_tpu/core/cameras.py``, with the
same conventions (identical to the reference so calibrations interoperate):
  cam   = R @ world + t
  world = R^T @ (cam - t)
  u     = fx * x/z + cx,  v = fy * y/z + cy
Depth maps store disparity (1/z) as float32; a pixel is valid iff its
disparity lies in [min_dsp, max_dsp].

Every formula keeps the JAX package's operand order (explicit
multiply-adds, no 3-wide matmuls), so the port and the hand-written CUDA
kernels in ``csrc/`` round the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class CameraBatch:
    """Structure-of-arrays batch of pinhole cameras: K [*,3,3], R [*,3,3],
    t [*,3]; width/height are plain ints, uniform across the batch."""
    K: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    width: int = 0
    height: int = 0

    def __len__(self):
        return self.K.shape[0]

    def __getitem__(self, idx) -> "CameraBatch":
        return CameraBatch(self.K[idx], self.R[idx], self.t[idx],
                           self.width, self.height)

    def to(self, device) -> "CameraBatch":
        return CameraBatch(self.K.to(device), self.R.to(device),
                           self.t.to(device), self.width, self.height)

    def expand_dims(self, n: int) -> "CameraBatch":
        """Append ``n`` singleton batch dims so the cameras broadcast
        against points with ``n`` more leading dims (e.g. [N] cameras
        against [N,H,W,3] points: ``expand_dims(2)``)."""
        K, R, t = self.K, self.R, self.t
        for _ in range(n):
            K = K.unsqueeze(-3)
            R = R.unsqueeze(-3)
            t = t.unsqueeze(-2)
        return CameraBatch(K, R, t, self.width, self.height)

    @property
    def fx(self):
        return self.K[..., 0, 0]

    @property
    def fy(self):
        return self.K[..., 1, 1]

    @property
    def cx(self):
        return self.K[..., 0, 2]

    @property
    def cy(self):
        return self.K[..., 1, 2]

    def centers(self):
        """Camera centers in world coordinates: C = -R^T t."""
        return -torch.einsum("...ji,...j->...i", self.R, self.t)



def _rot3(R, pts, transpose=False):
    """[...,3,3] x [...,3] -> [...,3] as explicit multiply-adds."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    if transpose:
        return torch.stack([
            R[..., 0, 0] * x + R[..., 1, 0] * y + R[..., 2, 0] * z,
            R[..., 0, 1] * x + R[..., 1, 1] * y + R[..., 2, 1] * z,
            R[..., 0, 2] * x + R[..., 1, 2] * y + R[..., 2, 2] * z,
        ], dim=-1)
    return torch.stack([
        R[..., 0, 0] * x + R[..., 0, 1] * y + R[..., 0, 2] * z,
        R[..., 1, 0] * x + R[..., 1, 1] * y + R[..., 1, 2] * z,
        R[..., 2, 0] * x + R[..., 2, 1] * y + R[..., 2, 2] * z,
    ], dim=-1)


def world_to_cam(cam: CameraBatch, pts):
    """world [...,3] -> camera frame [...,3]."""
    return _rot3(cam.R, pts) + cam.t


def cam_to_world(cam: CameraBatch, pts):
    """camera [...,3] -> world frame [...,3]."""
    return _rot3(cam.R, pts - cam.t, transpose=True)


def project(cam: CameraBatch, pts_world):
    """World points [...,3] -> (uv [...,2], z [...]) continuous pixel
    coords and camera-frame depth (|z| < 1e-12 divides by 1e-12)."""
    pc = world_to_cam(cam, pts_world)
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    u = cam.fx * pc[..., 0] * inv_z + cam.cx
    v = cam.fy * pc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1), z


def unproject(cam: CameraBatch, uv, depth):
    """Pixel coords [...,2] + depth [...] -> world points [...,3]."""
    x = (uv[..., 0] - cam.cx) * depth / cam.fx
    y = (uv[..., 1] - cam.cy) * depth / cam.fy
    pc = torch.stack([x, y, depth], dim=-1)
    return cam_to_world(cam, pc)


def pixel_grid(height: int, width: int, dtype=torch.float32, *, device):
    """[H,W,2] grid of (u,v) pixel coordinates (u = column, v = row)."""
    v, u = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                          torch.arange(width, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([u, v], dim=-1)


def unproject_depth_map(cam: CameraBatch, disparity, min_dsp: float,
                        max_dsp: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Disparity map [...,H,W] -> (world points [...,H,W,3], valid mask).
    ``cam`` batch dims must match the leading dims of ``disparity``."""
    h, w = disparity.shape[-2:]
    valid = (disparity >= min_dsp) & (disparity <= max_dsp)
    safe = torch.where(valid, disparity, torch.ones_like(disparity))
    depth = 1.0 / safe
    uv = pixel_grid(h, w, disparity.dtype, device=disparity.device)
    pts = unproject(cam.expand_dims(2), uv, depth)
    return torch.where(valid[..., None], pts, torch.zeros_like(pts)), valid

