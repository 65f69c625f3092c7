"""Foreground segmentation (the reference's GrabCut stand-in) and the
AllSeqProj mesh trim.

PyTorch counterpart of ``multiviewstitch_tpu/ops/segmentation.py``. The
reference optionally runs cv::grabCut at half resolution with a margin
rectangle as the foreground prior (Image3D.cpp:23-51, gated by ``Segment``)
to mask background pixels before feature detection. The stand-in keeps the
same contract — [H,W] boolean foreground mask from an RGB/gray image +
margin rectangle — with a colour-model EM over the rectangle prior:

  1. pixels outside the margin rectangle are hard background
  2. fixed-iteration k-means-like EM fits fg/bg colour clusters seeded by
     the rectangle interior/exterior
  3. per-pixel fg/bg assignment by nearest cluster + 3x3 majority rounds,
     mirroring GrabCut's GMM likelihood + smoothness.

The pipeline's ``segment`` knob uses ``foreground_from_disparity``: the
valid-disparity-range test (Image3D.cpp:95-103) is the robust segmentation
when depth is available.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.cameras import project
from ..core.transforms import inverse


def foreground_from_disparity(disparity, min_dsp: float, max_dsp: float):
    """[.,H,W] disparity -> foreground mask (valid depth range)."""
    return (disparity >= min_dsp) & (disparity <= max_dsp)


def segment_foreground(image: torch.Tensor, *, hl: float = 0.1,
                       hr: float = 0.25, vl: float = 0.33, vr: float = 0.25,
                       n_clusters: int = 4, iters: int = 8,
                       smooth_rounds: int = 2) -> torch.Tensor:
    """Margin-rectangle-seeded colour EM segmentation of a [H,W] gray or
    [H,W,C] image -> [H,W] bool on the image's device."""
    img = (image[..., None] if image.dim() == 2 else image).to(torch.float32)
    h, w, c = img.shape
    dev = img.device
    f32 = torch.float32
    # float32 coordinates: torch, like JAX, rounds the bounds to float32
    u = torch.arange(w, dtype=f32, device=dev)
    v = torch.arange(h, dtype=f32, device=dev)
    in_rect = ((u[None, :] >= hl * w) & (u[None, :] < w * (1 - hr)) &
               (v[:, None] >= vl * h) & (v[:, None] < h * (1 - vr)))
    flat = img.reshape(-1, c)
    rect = in_rect.reshape(-1)
    offs = torch.linspace(-1.0, 1.0, n_clusters, device=dev)[:, None]

    def seeded_means(sel):
        # quantile-spread seeds from the selected region
        wgt = sel.to(f32)
        n = wgt.sum().clamp_min(1.0)
        mu = (flat * wgt[:, None]).sum(0) / n
        sd = torch.sqrt(((flat - mu) ** 2 * wgt[:, None]).sum(0) / n + 1e-6)
        return mu[None, :] + offs * sd[None, :]

    def dist2(mu):
        return ((flat[:, None, :] - mu[None]) ** 2).sum(-1)     # [P,K]

    def update(mu, asg, sel):
        wsel = sel.to(f32)
        acc = torch.zeros_like(mu).index_add_(0, asg, flat * wsel[:, None])
        cnt = torch.zeros(mu.shape[0], device=dev).index_add_(0, asg, wsel)
        return torch.where(cnt[:, None] > 0,
                           acc / cnt[:, None].clamp_min(1.0), mu)

    fg_mu, bg_mu = seeded_means(rect), seeded_means(~rect)
    for _ in range(iters):
        dfg, afg = dist2(fg_mu).min(1)
        dbg, abg = dist2(bg_mu).min(1)
        is_fg = (dfg < dbg) & rect      # outside rect stays background
        fg_mu, bg_mu = update(fg_mu, afg, is_fg), update(bg_mu, abg, ~is_fg)

    dfg = dist2(fg_mu).min(1).values
    dbg = dist2(bg_mu).min(1).values
    mask = ((dfg < dbg) & rect).reshape(h, w)

    # smoothness: 3x3 majority vote rounds (GrabCut's pairwise term analogue)
    for _ in range(smooth_rounds):
        m = mask.to(f32)
        acc = m.clone()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    acc += torch.roll(m, (dy, dx), (0, 1))
        mask = (acc / 9.0 > 0.5) & in_rect
    return mask


def trim_mesh_by_all_cameras(vertices, faces, normals, transforms,
                             sequences_cams):
    """AllSeqProj trim (Processor.cpp:1064-1102): drop vertices that fall
    outside ANY camera of ANY sequence after inverse-mapping the fused model
    into that sequence's frame; faces reindexed. ``vertices``/``faces``
    (and ``normals``, or None) are numpy; the projection runs on the
    cameras' device."""
    dev = sequences_cams[0].K.device
    v = torch.as_tensor(np.asarray(vertices, np.float32), device=dev)
    keep = torch.ones(len(vertices), dtype=torch.bool, device=dev)
    for T, cams in zip(transforms, sequences_cams):
        inv = inverse(T.to(dev))
        pts = inv.s * torch.einsum("ij,nj->ni", inv.R, v) + inv.t
        uv, z = project(cams.expand_dims(1), pts[None])         # [N,V]
        inb = ((uv[..., 0] >= 0) & (uv[..., 0] <= cams.width - 1) &
               (uv[..., 1] >= 0) & (uv[..., 1] <= cams.height - 1) &
               (z > 0))
        keep &= inb.all(0)
    keep = keep.cpu().numpy()
    remap = np.cumsum(keep) - 1
    fmask = keep[faces].all(1)
    new_faces = remap[faces[fmask]].astype(np.int32)
    new_norms = normals[keep] if normals is not None else None
    return vertices[keep], new_faces, new_norms
