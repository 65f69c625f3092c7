"""Virtual-view synthesis by homography warp (the reference's GenNewViews).

PyTorch counterpart of ``multiviewstitch_tpu/ops/view_synth.py``: for each
angle about the camera's ``axis``-th basis vector, H = K R(angle) K^-1;
the valid region of the 2x expanded destination grid is re-centred with
integer offsets (so the zero-angle view is the identity), the source is
bilinear-sampled directly, and texIndex maps each synthesized pixel to its
nearest source pixel (-1 = unmapped).

The JAX package samples through a banded MXU gather that marks pixels
outside its windows unmapped; the direct warp here maps them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.transforms import rotation_about_axis


class SynthViews(NamedTuple):
    images: torch.Tensor      # [V,H,W,C] warped views (0 outside coverage)
    tex_index: torch.Tensor   # [V,H,W] int32 source pixel v*W+u, -1 invalid


def view_angles(view_count: int, rot_angle_deg: float, *, device):
    """[-a*(c/2), ..., -a, 0, a, ..., a*(c/2)] (view_count entries), rad."""
    half = view_count // 2
    deg = ([-rot_angle_deg * i for i in range(half, 0, -1)] +
           [rot_angle_deg * i for i in range(0, half + 1)])[:view_count]
    return torch.tensor(deg, dtype=torch.float32, device=device) * (
        math.pi / 180.0)


def _bilinear_sample(srcs, sy, sx):
    """Bilinear sample srcs [C,H,W] at continuous (sy, sx) [...] with the
    JAX package's edge clamping: x0 = clip(floor(sx), 0, W-2),
    fx = clip(sx - x0, 0, 1), same in y. Returns [C,...]."""
    C, H, W = srcs.shape
    x0 = torch.floor(sx).clamp(0.0, W - 2.0)
    y0 = torch.floor(sy).clamp(0.0, H - 2.0)
    fx = (sx - x0).clamp(0.0, 1.0)
    fy = (sy - y0).clamp(0.0, 1.0)
    x0i = x0.long()
    y0i = y0.long()
    flat = srcs.reshape(C, -1)

    def tap(yi, xi):
        return flat[:, (yi * W + xi).reshape(-1)].reshape(C, *sx.shape)

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1 - fx) + tap(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


def _warp_field(Hm, gu, gv):
    wf = Hm[2, 0] * gu + Hm[2, 1] * gv + Hm[2, 2]
    uf = (Hm[0, 0] * gu + Hm[0, 1] * gv + Hm[0, 2]) / wf
    vf = (Hm[1, 0] * gu + Hm[1, 1] * gv + Hm[1, 2]) / wf
    return uf, vf


def synthesize_views(image, K, R, angles, *, axis: int = 1) -> SynthViews:
    """image [H,W,C]; K, R [3,3]; angles [V] radians."""
    h, w = image.shape[:2]
    dev = image.device
    ax = R[axis, :]
    Kinv = torch.stack([
        torch.stack([1.0 / K[0, 0], K.new_zeros(()), -K[0, 2] / K[0, 0]]),
        torch.stack([K.new_zeros(()), 1.0 / K[1, 1], -K[1, 2] / K[1, 1]]),
        torch.tensor([0.0, 0.0, 1.0], dtype=K.dtype, device=dev)])
    uu = torch.arange(2 * w, dtype=torch.float32, device=dev) - w * 0.5
    vv = torch.arange(2 * h, dtype=torch.float32, device=dev) - h * 0.5
    gv, gu = torch.meshgrid(vv, uu, indexing="ij")
    srcs = image.to(torch.float32).permute(2, 0, 1)        # [C,H,W]
    eps = 1e-3
    big = 1e9
    imgs, texs = [], []
    for a in range(angles.shape[0]):
        Hm = K @ rotation_about_axis(ax, angles[a]) @ Kinv
        uf, vf = _warp_field(Hm, gu, gv)
        inr = ((uf >= -eps) & (uf <= w - 1 + eps) &
               (vf >= -eps) & (vf <= h - 1 + eps))
        gu_abs = gu + w * 0.5
        gv_abs = gv + h * 0.5
        minu = torch.where(inr, gu_abs, torch.full_like(gu, big)).min()
        maxu = torch.where(inr, gu_abs, torch.full_like(gu, -big)).max()
        minv = torch.where(inr, gv_abs, torch.full_like(gv, big)).min()
        maxv = torch.where(inr, gv_abs, torch.full_like(gv, -big)).max()
        offx = torch.floor((maxu + minu) * 0.5 - (w - 1) * 0.5 + 0.5)
        offy = torch.floor((maxv + minv) * 0.5 - (h - 1) * 0.5 + 0.5)
        cu = torch.arange(w, dtype=torch.float32, device=dev) + (
            offx - w * 0.5)
        cv = torch.arange(h, dtype=torch.float32, device=dev) + (
            offy - h * 0.5)
        gvw, guw = torch.meshgrid(cv, cu, indexing="ij")
        ufw, vfw = _warp_field(Hm, guw, gvw)
        inrw = ((ufw >= -eps) & (ufw <= w - 1 + eps) &
                (vfw >= -eps) & (vfw <= h - 1 + eps))
        zero = torch.zeros_like(ufw)
        ufc = torch.where(torch.isfinite(ufw), ufw, zero).clamp(0.0, w - 1.0)
        vfc = torch.where(torch.isfinite(vfw), vfw, zero).clamp(0.0, h - 1.0)
        sample = _bilinear_sample(srcs, vfc, ufc).permute(1, 2, 0)  # [h,w,C]
        tex = torch.where(
            inrw,
            torch.floor(vfc + 0.5).to(torch.int32) * w +
            torch.floor(ufc + 0.5).to(torch.int32),
            torch.full_like(ufw, -1, dtype=torch.int32))
        imgs.append(torch.where((tex >= 0)[..., None], sample,
                                torch.zeros_like(sample)))
        texs.append(tex)
    return SynthViews(torch.stack(imgs), torch.stack(texs))
