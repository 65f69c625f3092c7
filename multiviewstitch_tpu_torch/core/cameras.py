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

import numpy as np
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


# ---------------------------------------------------------------------------
# .act calibration files (host-side text).
# ---------------------------------------------------------------------------

def load_act(path: str, *, device) -> CameraBatch:
    """Parse the reference's .act calibration format into a CameraBatch on
    ``device``.

    Format (LoadCalibrationFromActs, Camera.cpp:74-157):
      - '#' comment lines; blank lines ignored outside blocks
      - '<intrinsic parameter>' followed by a line 'fx fy cx cy'
      - 'start:<i>', 'step:<i>', 'end:<i>'
      - '<Camera Track>' then per frame: separator line, frame-name line,
        four rows of a 4x4 [R|t; 0 0 0 1] matrix, separator line.
    Image size: W = 2*(cx+0.5), H = 2*(cy+0.5)  (Camera.cpp:135-136).
    """
    with open(path, "r") as f:
        lines = f.read().splitlines()

    K = np.zeros((3, 3), np.float64)
    start = step = end = 0
    Rs, ts = [], []
    i = 0
    n = len(lines)
    while i < n:
        s = lines[i].strip()
        i += 1
        if not s or s.startswith("#"):
            continue
        if s == "<intrinsic parameter>":
            vals = [float(x) for x in lines[i].split()]
            i += 1
            K[0, 0], K[1, 1], K[0, 2], K[1, 2] = vals[:4]
            K[2, 2] = 1.0
        elif s == "<Camera Track>":
            nframes = 0 if step == 0 else (end - start) // step + 1
            for _ in range(max(nframes, 0)):
                i += 2  # separator + frame-name lines
                rows = []
                for _r in range(4):
                    rows.append([float(x) for x in lines[i].split()])
                    i += 1
                i += 1  # trailing separator
                M = np.asarray(rows[:3], np.float64)
                Rs.append(M[:, :3])
                ts.append(M[:, 3])
            break
        elif ":" in s:
            key, _, val = s.partition(":")
            key = key.strip()
            if key == "start":
                start = int(val)
            elif key == "step":
                step = int(val)
            elif key == "end":
                end = int(val)

    nf = len(Rs)
    R = np.stack(Rs) if nf else np.zeros((0, 3, 3))
    t = np.stack(ts) if nf else np.zeros((0, 3))
    width = int(2 * (K[0, 2] + 0.5))
    height = int(2 * (K[1, 2] + 0.5))
    Kb = np.broadcast_to(K, (nf, 3, 3))
    f32 = dict(dtype=torch.float32, device=device)
    return CameraBatch(torch.as_tensor(Kb.astype(np.float32), **f32),
                       torch.as_tensor(R.astype(np.float32), **f32),
                       torch.as_tensor(t.astype(np.float32), **f32),
                       width, height)


def save_act(path: str, cam: CameraBatch, start: int = 0, step: int = 1):
    """Write a CameraBatch in the reference .act format (round-trips
    load_act; the same text as the JAX package's save_act)."""
    K = cam.K.cpu().numpy()
    R = cam.R.cpu().numpy()
    t = cam.t.cpu().numpy()
    nf = R.shape[0]
    with open(path, "w") as f:
        f.write("# multiviewstitch_tpu calibration\n")
        f.write("<intrinsic parameter>\n")
        f.write(f"{K[0,0,0]} {K[0,1,1]} {K[0,0,2]} {K[0,1,2]}\n")
        f.write(f"start:{start}\nstep:{step}\nend:{start + step * (nf - 1)}\n")
        f.write("<Camera Track>\n")
        for fi in range(nf):
            f.write("----\n")
            f.write(f"frame{start + fi * step}\n")
            for r in range(3):
                f.write(f"{R[fi,r,0]} {R[fi,r,1]} {R[fi,r,2]} {t[fi,r]}\n")
            f.write("0 0 0 1\n")
            f.write("----\n")

