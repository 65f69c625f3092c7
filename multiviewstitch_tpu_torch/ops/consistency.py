"""Cross-view depth-consistency filtering.

PyTorch counterpart of ``multiviewstitch_tpu/ops/consistency.py``
(Processor::CheckConsistency of the reference). A pixel keeps its
disparity iff it is valid and, for every existing neighbour frame at
``offsets`` (default -1 and +1), its unprojection lands inside the
neighbour image on a valid neighbour pixel whose own unprojection
reprojects within ``reproj_err`` px of the pixel. A neighbour outside the
sequence casts no vote.

On the card the whole filter is one kernel (K1, ``csrc/consistency.cu``);
``check_consistency_reference`` is its plain PyTorch version, taken for CPU
tensors. The JAX package's TPU gather marks targets outside a band window
invalid; the direct gather here serves every target, like the JAX CPU path
the tests hold it against.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..core.cameras import CameraBatch, project, unproject, pixel_grid


def gather_px_frames(imgs, vy, vx):
    """Per-frame integer gather: imgs [N,H,W] at (vy, vx) [N,Ho,Wo] (indices
    clipped into the frame) -> vals [N,Ho,Wo]. The plain counterpart of
    ``pallas_gather_banded`` with every target in its window."""
    n, h, w = imgs.shape
    flat = (vy.clamp(0, h - 1) * w + vx.clamp(0, w - 1)).reshape(n, -1)
    return torch.gather(imgs.reshape(n, -1), 1, flat.long()).reshape(
        vy.shape)


def _round_px(x):
    """C++ ``(int)(x + 0.5)`` kept in float (no int overflow far off-image)."""
    return torch.floor(x + 0.5)


def _offset_check(pts, cam_pix: CameraBatch, uv, ndisp, ncams: CameraBatch,
                  *, min_dsp, max_dsp, reproj_err):
    """Round-trip test of every pixel against one neighbour assignment.
    pts [N,H,W,3]; returns ok [N,H,W]."""
    h, w = ndisp.shape[-2:]
    ncams_pix = ncams.expand_dims(2)
    uvn, zn = project(ncams_pix, pts)
    un, vn = _round_px(uvn[..., 0]), _round_px(uvn[..., 1])
    inb1 = (un >= 0) & (un <= w - 1) & (vn >= 0) & (vn <= h - 1) & (zn > 0)
    uc = un.clamp(0, w - 1)
    vc = vn.clamp(0, h - 1)
    dn = gather_px_frames(ndisp, vc.long(), uc.long())
    ref_valid = (dn >= min_dsp) & (dn <= max_dsp)
    ptsn = unproject(ncams_pix, torch.stack([uc, vc], -1),
                     1.0 / torch.where(ref_valid, dn, torch.ones_like(dn)))
    uvb, _ = project(cam_pix, ptsn)
    ub, vb = _round_px(uvb[..., 0]), _round_px(uvb[..., 1])
    inb2 = (ub >= 0) & (ub <= w - 1) & (vb >= 0) & (vb <= h - 1)
    du = uv[None, ..., 0] - ub
    dv = uv[None, ..., 1] - vb
    err_ok = du * du + dv * dv <= float(reproj_err) * float(reproj_err)
    return inb1 & ref_valid & inb2 & err_ok


def check_consistency_reference(disparity, cams: CameraBatch, *,
                                min_dsp: float, max_dsp: float,
                                reproj_err: float, offsets=(-1, 1)):
    """Plain PyTorch version of K1 (the JAX function's semantics)."""
    n, h, w = disparity.shape
    dev = disparity.device
    valid = (disparity >= min_dsp) & (disparity <= max_dsp)
    uv = pixel_grid(h, w, disparity.dtype, device=dev)
    depth = 1.0 / torch.where(valid, disparity, torch.ones_like(disparity))
    cam_pix = cams.expand_dims(2)
    pts = unproject(cam_pix, uv[None], depth)
    keep = valid
    ar = torch.arange(n, device=dev)
    for off in offsets:
        nbr = (ar + off).clamp(0, n - 1)
        exists = ((ar + off >= 0) & (ar + off < n))[:, None, None]
        ok = _offset_check(pts, cam_pix, uv, disparity[nbr], cams[nbr],
                           min_dsp=min_dsp, max_dsp=max_dsp,
                           reproj_err=reproj_err)
        keep = keep & torch.where(exists, ok, torch.ones_like(ok))
    return torch.where(keep, disparity, torch.zeros_like(disparity))


def check_consistency(disparity, cams: CameraBatch, *, min_dsp: float,
                      max_dsp: float, reproj_err: float, offsets=(-1, 1)):
    """Filter a sequence [N,H,W] of disparity maps by cross-view
    consistency against the frames at ``offsets``; inconsistent pixels
    become 0. K1 on CUDA tensors."""
    if disparity.device.type == "cuda":
        return kernels.consistency(
            disparity.contiguous(), cams.K.contiguous(),
            cams.R.contiguous(), cams.t.contiguous(), min_dsp=min_dsp,
            max_dsp=max_dsp, reproj_err=reproj_err, offsets=offsets)
    if disparity.device.type == "cpu":
        return check_consistency_reference(
            disparity, cams, min_dsp=min_dsp, max_dsp=max_dsp,
            reproj_err=reproj_err, offsets=offsets)
    raise ValueError(f"check_consistency: unsupported device "
                     f"{disparity.device}")


def consistency_stats(before, after, min_dsp: float, max_dsp: float):
    """Per-sequence metrics: valid fraction before/after filtering."""
    v0 = ((before >= min_dsp) & (before <= max_dsp)).float().mean()
    v1 = ((after >= min_dsp) & (after <= max_dsp)).float().mean()
    return {"valid_before": float(v0), "valid_after": float(v1)}
