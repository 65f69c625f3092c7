"""Multi-frame point sampling with normals + confidence (GeoRec part 1).

PyTorch counterpart of ``multiviewstitch_tpu/ops/point_sampling.py``:
  - sample the pixel grid at ``sample_radius`` stride
  - normal = normalized cross product of the world-space depth-map
    tangents (central differences, wrapping at the border like the JAX
    package's ``jnp.roll``), oriented to face the camera
  - confidence = fraction of existing neighbour frames (i +- k*step,
    k=1..nbr_num) whose disparity at the reprojected pixel agrees within
    ``dsp_err``
  - keep points with confidence >= ``conf_min``

On the card the whole sampler is one kernel (K2, ``csrc/sampling.cu``):
points, normals, confidences and the keep mask of every strided sample,
with no full-resolution [N,H,W,3] array. ``sample_oriented_points_reference``
(with ``sampling_votes_reference`` for the confidences) is its plain
PyTorch version, taken for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..core.cameras import CameraBatch, project, unproject, pixel_grid
from .consistency import gather_px_frames


class OrientedPoints(NamedTuple):
    points: torch.Tensor    # [N, S, 3] world points (S = samples per frame)
    normals: torch.Tensor   # [N, S, 3]
    conf: torch.Tensor      # [N, S] agreement confidence
    valid: torch.Tensor     # [N, S] bool


def sampling_votes_reference(pts_s, disparity, cams: CameraBatch, *,
                             nbr_num: int, nbr_step: int, min_dsp: float,
                             max_dsp: float, dsp_err: float):
    """The confidences of ``sample_oriented_points_reference``: conf
    [N,Hs,Ws] of sample points pts_s [N,Hs,Ws,3] against the +-k*step
    neighbour frames."""
    n, h, w = disparity.shape
    dev = disparity.device
    votes = torch.zeros(pts_s.shape[:3], dtype=disparity.dtype, device=dev)
    exists_total = torch.zeros_like(votes)
    ar = torch.arange(n, device=dev)
    for k in range(1, nbr_num + 1):
        for sgn in (-1, 1):
            off = sgn * k * nbr_step
            nbr = (ar + off).clamp(0, n - 1)
            exists = ((ar + off >= 0) & (ar + off < n)).to(disparity.dtype)
            uvn, zn = project(cams[nbr].expand_dims(2), pts_s)
            un = torch.floor(uvn[..., 0] + 0.5)
            vn = torch.floor(uvn[..., 1] + 0.5)
            inb = ((un >= 0) & (un <= w - 1) & (vn >= 0) & (vn <= h - 1) &
                   (zn > 0))
            dn = gather_px_frames(disparity[nbr], vn.clamp(0, h - 1).long(),
                                  un.clamp(0, w - 1).long())
            d_proj = torch.where(zn > 1e-12, 1.0 / zn.clamp_min(1e-12),
                                 torch.zeros_like(zn))
            agree = (inb & ((dn - d_proj).abs() <= dsp_err) &
                     (dn >= min_dsp) & (dn <= max_dsp))
            votes = votes + torch.where(exists[:, None, None] > 0,
                                        agree.to(votes.dtype),
                                        torch.zeros_like(votes))
            exists_total = exists_total + exists[:, None, None]
    conf = votes / exists_total.clamp_min(1.0)
    return torch.where(exists_total > 0, conf, torch.ones_like(conf))


def sample_oriented_points(disparity, cams: CameraBatch, *, min_dsp: float,
                           max_dsp: float, sample_radius: int = 2,
                           nbr_num: int = 2, nbr_step: int = 1,
                           dsp_err: float = 0.01,
                           conf_min: float = 0.6) -> OrientedPoints:
    """Oriented points [N,S,3], normals, confidences and keep mask of a
    disparity stack [N,H,W]. K2 on CUDA tensors (the camera centres come
    from ``cams.centers()``, as in the plain version), the plain version on
    CPU tensors."""
    kw = dict(min_dsp=min_dsp, max_dsp=max_dsp, sample_radius=sample_radius,
              nbr_num=nbr_num, nbr_step=nbr_step, dsp_err=dsp_err,
              conf_min=conf_min)
    if disparity.device.type == "cuda":
        return OrientedPoints(*kernels.oriented_points(
            disparity.contiguous(), cams.K.contiguous(), cams.R.contiguous(),
            cams.t.contiguous(), cams.centers().contiguous(), **kw))
    if disparity.device.type == "cpu":
        return sample_oriented_points_reference(disparity, cams, **kw)
    raise ValueError(f"sample_oriented_points: unsupported device "
                     f"{disparity.device}")


def sample_oriented_points_reference(
        disparity, cams: CameraBatch, *, min_dsp: float, max_dsp: float,
        sample_radius: int = 2, nbr_num: int = 2, nbr_step: int = 1,
        dsp_err: float = 0.01, conf_min: float = 0.6) -> OrientedPoints:
    """Plain PyTorch version of K2 (and the JAX function's semantics)."""
    n, h, w = disparity.shape
    dev = disparity.device
    valid = (disparity >= min_dsp) & (disparity <= max_dsp)
    depth = 1.0 / torch.where(valid, disparity, torch.ones_like(disparity))
    uv = pixel_grid(h, w, disparity.dtype, device=dev)
    pts = unproject(cams.expand_dims(2), uv[None], depth)   # [N,H,W,3]

    r = sample_radius
    s_h = len(range(0, h, r))
    s_w = len(range(0, w, r))
    pts_s = pts[:, ::r, ::r]
    valid_s = valid[:, ::r, ::r]

    def shift(a, dy, dx):
        return torch.roll(a, shifts=(-dy, -dx), dims=(1, 2))[:, ::r, ::r]

    zero = torch.zeros((), dtype=pts.dtype, device=dev)
    du = torch.where((shift(valid, 0, 1) & shift(valid, 0, -1))[..., None],
                     shift(pts, 0, 1) - shift(pts, 0, -1), zero)
    dv = torch.where((shift(valid, 1, 0) & shift(valid, -1, 0))[..., None],
                     shift(pts, 1, 0) - shift(pts, -1, 0), zero)
    nrm = torch.cross(dv, du, dim=-1)
    nlen = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    has_n = nlen[..., 0] > 1e-12
    nrm = nrm / nlen.clamp_min(1e-12)
    C = cams.centers()[:, None, None, :]
    flip = (nrm * (C - pts_s)).sum(-1) < 0
    nrm = torch.where(flip[..., None], -nrm, nrm)

    conf = sampling_votes_reference(pts_s, disparity, cams, nbr_num=nbr_num,
                                    nbr_step=nbr_step, min_dsp=min_dsp,
                                    max_dsp=max_dsp, dsp_err=dsp_err)
    keep = valid_s & has_n & (conf >= conf_min)
    return OrientedPoints(pts_s.reshape(n, s_h * s_w, 3),
                          nrm.reshape(n, s_h * s_w, 3),
                          conf.reshape(n, s_h * s_w),
                          keep.reshape(n, s_h * s_w))


def visibility_filter(points, valid, cams: CameraBatch):
    """Drop points that project outside ANY camera of the rig.
    points [S,3]; cams batch [N]; returns updated valid [S]."""
    uv, z = project(cams.expand_dims(1), points[None])     # [N,S,2], [N,S]
    inb = ((uv[..., 0] >= 0) & (uv[..., 0] <= cams.width - 1) &
           (uv[..., 1] >= 0) & (uv[..., 1] <= cams.height - 1) & (z > 0))
    return valid & inb.all(dim=0)
