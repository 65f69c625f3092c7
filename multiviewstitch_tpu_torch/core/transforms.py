"""Similarity transforms (s, R, t) and their algebra.

PyTorch counterpart of ``multiviewstitch_tpu/core/transforms.py``:
x -> s * R @ x + t with optional leading batch dims.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Similarity:
    """x -> s * R @ x + t.  s: [...], R: [...,3,3], t: [...,3]."""
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), *, device) -> "Similarity":
        s = torch.ones(batch_shape, device=device)
        R = torch.eye(3, device=device).expand(*batch_shape, 3, 3).clone()
        t = torch.zeros(*batch_shape, 3, device=device)
        return Similarity(s, R, t)

    def __getitem__(self, idx) -> "Similarity":
        return Similarity(self.s[idx], self.R[idx], self.t[idx])

    def to(self, device) -> "Similarity":
        return Similarity(self.s.to(device), self.R.to(device),
                          self.t.to(device))


def apply_points(T: Similarity, pts):
    """Apply a single (unbatched) similarity to points [...,3]."""
    return T.s * torch.einsum("ij,...j->...i", T.R, pts) + T.t


def rotate_normals(T: Similarity, normals):
    """Rotate unit normals (uniform scale preserves them)."""
    return torch.einsum("ij,...j->...i", T.R, normals)


def compose(A: Similarity, B: Similarity) -> Similarity:
    """(A o B)(x) = A(B(x)): s = sA*sB, R = RA@RB, t = sA*RA@tB + tA."""
    s = A.s * B.s
    R = torch.einsum("...ij,...jk->...ik", A.R, B.R)
    t = A.s[..., None] * torch.einsum("...ij,...j->...i", A.R, B.t) + A.t
    return Similarity(s, R, t)


def inverse(T: Similarity) -> Similarity:
    """x -> 1/s R^T (x - t)."""
    s = 1.0 / T.s
    R = T.R.transpose(-1, -2)
    t = -s[..., None] * torch.einsum("...ij,...j->...i", R, T.t)
    return Similarity(s, R, t)


def rotation_about_axis(axis, angle):
    """Rodrigues rotation matrix about unit axis [...,3] by angle [...]
    (radians)."""
    axis = torch.as_tensor(axis)
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c, s = torch.cos(angle), torch.sin(angle)
    C = 1.0 - c
    return torch.stack([
        torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s], -1),
        torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s], -1),
        torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C], -1),
    ], dim=-2)


def rotation_between(a, b, eps: float = 1e-12):
    """Rotation matrix taking direction a [...,3] to direction b (the
    reference's CalcRotation, Common/Utils.h:140-149: axis = a x b, angle
    from the dot product). Identity for parallel vectors, a half turn about
    a perpendicular axis for antiparallel ones."""
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True).clamp_min(eps)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True).clamp_min(eps)
    axis = torch.linalg.cross(a, b, dim=-1)
    s = torch.linalg.norm(axis, dim=-1)
    c = (a * b).sum(-1)
    angle = torch.atan2(s, c)
    ex = a.new_tensor([1.0, 0.0, 0.0])
    ey = a.new_tensor([0.0, 1.0, 0.0])
    safe_axis = torch.where(s[..., None] > eps,
                            axis / s[..., None].clamp_min(eps), ex)
    R = rotation_about_axis(safe_axis, angle)
    perp = torch.linalg.cross(a, ex.expand_as(a), dim=-1)
    perp2 = torch.linalg.cross(a, ey.expand_as(a), dim=-1)
    perp = torch.where(torch.linalg.norm(perp, dim=-1, keepdim=True) > 1e-6,
                       perp, perp2)
    perp = perp / torch.linalg.norm(perp, dim=-1, keepdim=True).clamp_min(eps)
    R_pi = rotation_about_axis(perp, torch.full_like(s, math.pi))
    anti = (s <= eps) & (c < 0)
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand_as(R)
    return torch.where(anti[..., None, None], R_pi,
                       torch.where((s <= eps)[..., None, None], eye, R))


def rotation_angle_deg(Ra, Rb) -> float:
    """Angle of the relative rotation Ra @ Rb^T in degrees (host floats)."""
    dR = np.array(Ra, np.float64) @ np.array(Rb, np.float64).T
    c = float((np.trace(dR) - 1.0) / 2.0)
    return math.degrees(math.acos(min(max(c, -1.0), 1.0)))
