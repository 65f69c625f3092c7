"""Plain camera and similarity arithmetic of the benchmark (torch only).

Conventions (the reference's, Camera.cpp): cam = R world + t, world =
R^T (cam - t), u = fx x/z + cx, v = fy y/z + cy; depth maps hold
disparity 1/z.

Two forms of the same arithmetic:
  - ``rot_madd`` and the functions built on it write each product as
    explicit multiply-adds in the operand order of the scene fixtures the
    benchmark froze, so the generated scenes are those fixtures' scenes;
  - ``Mat`` writes every camera product as a matrix product (``K``,
    ``K^-1``, ``R``), as a plain implementation would. The reference
    (``reference.py``) uses it; with ``precision="tf32"`` the operands of
    every product are first rounded to TF32's 10-bit mantissa, which is
    the lower-precision control of the correctness check.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Cams(NamedTuple):
    """A batch of pinhole cameras: K [N,3,3], R [N,3,3], t [N,3]."""
    K: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    width: int
    height: int

    def to(self, device) -> "Cams":
        return Cams(self.K.to(device), self.R.to(device), self.t.to(device),
                    self.width, self.height)

    def __len__(self):
        return self.K.shape[0]


class Sim(NamedTuple):
    """A similarity x -> s R x + t (float64 numpy)."""
    s: float
    R: np.ndarray
    t: np.ndarray

    def apply(self, pts: np.ndarray) -> np.ndarray:
        return self.s * pts @ self.R.T + self.t

    def inverse(self) -> "Sim":
        return Sim(1.0 / self.s, self.R.T, -(self.R.T @ self.t) / self.s)


def yaw_sim(s: float, yaw_deg: float, t) -> Sim:
    """s, a rotation of ``yaw_deg`` about +y, and t."""
    a = math.radians(yaw_deg)
    R = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                  [-math.sin(a), 0.0, math.cos(a)]])
    return Sim(float(s), R, np.asarray(t, np.float64))


def rotation_angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Angle of Ra Rb^T in degrees."""
    c = (np.trace(np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T)
         - 1.0) / 2.0
    return math.degrees(math.acos(min(max(c, -1.0), 1.0)))


# -- the fixtures' multiply-add form ------------------------------------------

def rot_madd(R, p, transpose=False):
    """R [...,3,3] times p [...,3] as explicit multiply-adds."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    if transpose:
        return torch.stack([
            R[..., 0, 0] * x + R[..., 1, 0] * y + R[..., 2, 0] * z,
            R[..., 0, 1] * x + R[..., 1, 1] * y + R[..., 2, 1] * z,
            R[..., 0, 2] * x + R[..., 1, 2] * y + R[..., 2, 2] * z], -1)
    return torch.stack([
        R[..., 0, 0] * x + R[..., 0, 1] * y + R[..., 0, 2] * z,
        R[..., 1, 0] * x + R[..., 1, 1] * y + R[..., 1, 2] * z,
        R[..., 2, 0] * x + R[..., 2, 1] * y + R[..., 2, 2] * z], -1)


def pixel_grid(height: int, width: int, *, device):
    """[H,W,2] float32 (u = column, v = row)."""
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                       device=device),
                          torch.arange(width, dtype=torch.float32,
                                       device=device), indexing="ij")
    return torch.stack([u, v], -1)


def unproject_madd(K, R, t, uv, depth):
    """Pixels uv [...,2] at depth [...] -> world [...,3]; K, R, t
    broadcast against the pixels' leading dims."""
    x = (uv[..., 0] - K[..., 0, 2]) * depth / K[..., 0, 0]
    y = (uv[..., 1] - K[..., 1, 2]) * depth / K[..., 1, 1]
    return rot_madd(R, torch.stack([x, y, depth], -1) - t, transpose=True)


# -- the reference's matrix form ----------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10-bit mantissa, nearest, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class Mat:
    """Matrix products of the reference, in float32 or with TF32 operands."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def _r(self, x):
        return tf32(x) if self.precision == "tf32" else x

    def mv(self, M, p):
        """M [...,3,3] @ p [...,3] -> [...,3]."""
        return (self._r(M) @ self._r(p)[..., None])[..., 0]

    def world_to_cam(self, R, t, p):
        return self.mv(R, p) + t

    def cam_to_world(self, R, t, pc):
        return self.mv(R.transpose(-1, -2), pc - t)

    def project(self, K, R, t, p):
        """World p [...,3] -> (uv [...,2], z [...])."""
        pc = self.world_to_cam(R, t, p)
        q = self.mv(K, pc)
        z = pc[..., 2]
        w = torch.where(q[..., 2].abs() < 1e-12,
                        torch.full_like(z, 1e-12), q[..., 2])
        return q[..., :2] / w[..., None], z

    def unproject(self, K, R, t, uv, depth):
        ones = torch.ones_like(uv[..., :1])
        ray = self.mv(torch.linalg.inv(K.double()).float(),
                      torch.cat([uv, ones], -1))
        return self.cam_to_world(R, t, ray * depth[..., None])
