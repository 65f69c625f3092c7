"""DoG keypoints + SIFT-layout descriptors, batched over images.

PyTorch counterpart of ``multiviewstitch_tpu/ops/features.py`` (DoG
detector only):
  - scale space: separable Gaussian pyramid with edge-replicate padding
  - detector: 27-neighbourhood DoG extrema (ties admitted, ``>=``, like the
    JAX package), contrast threshold, Hessian edge rejection; neighbourhoods
    wrap at the image border (``torch.roll``, as ``jnp.roll`` does)
  - per-octave candidates by exact ``topk``, quadratic subpixel and scale
    refinement, final exact top-K across octaves
  - orientation: 36-bin histogram over a scale-matched 16x16 gradient grid;
    a rival peak >= 0.8 of the maximum adds a second keypoint
  - descriptor: 4x4x8 trilinear histogram, L2-normalised with 0.2 clipping

Gradients are sampled bilinearly straight from an octave-downsampled
gradient pyramid (the JAX package goes through 64x64 MXU windows with bf16
weights; the samples agree up to that rounding and the window clamp).
Blurs are explicit f32 tap sums, never a TF32 convolution.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .filters import margin_mask


class Keypoints(NamedTuple):
    uv: torch.Tensor        # [...,K,2] float32 source-image pixel coords
    scale: torch.Tensor     # [...,K] pyramid sampling step
    angle: torch.Tensor     # [...,K] dominant orientation (rad)
    score: torch.Tensor     # [...,K] detector response
    valid: torch.Tensor     # [...,K] bool
    desc: torch.Tensor      # [...,K,128] L2-normalized descriptors


def _gauss_kernel1d(sigma: float, radius: int, device):
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _conv_valid(x, k, dim):
    """'valid' correlation of x with the symmetric kernel k along dim."""
    n = x.shape[dim] - (k.shape[0] - 1)
    out = x.narrow(dim, 0, n) * k[0]
    for j in range(1, k.shape[0]):
        out = out + x.narrow(dim, j, n) * k[j]
    return out


def gaussian_blur(img, sigma: float):
    """Separable Gaussian blur of [...,H,W] (edge-replicate padding)."""
    radius = max(1, int(3.0 * sigma + 0.5))
    k = _gauss_kernel1d(sigma, radius, img.device)
    h = img.shape[-2]
    x = torch.cat([img[..., :1, :].expand(*img.shape[:-2], radius,
                                          img.shape[-1]), img,
                   img[..., h - 1:, :].expand(*img.shape[:-2], radius,
                                              img.shape[-1])], dim=-2)
    x = _conv_valid(x, k, x.dim() - 2)
    w = x.shape[-1]
    x = torch.cat([x[..., :1].expand(*x.shape[:-1], radius), x,
                   x[..., w - 1:].expand(*x.shape[:-1], radius)], dim=-1)
    return _conv_valid(x, k, x.dim() - 1)


def _downsample2(img):
    return img[..., ::2, ::2]


def _grad_level(scale, num_grad_levels: int):
    """Gradient-pyramid level whose smoothing matches the keypoint scale
    (half-octave steps: sigma_l = 1.6 * 2^(l/2))."""
    lv = torch.round(2.0 * torch.log2(scale.clamp_min(1e-6)))
    return lv.to(torch.int64).clamp(0, num_grad_levels - 1)


class _GradPyramid(NamedTuple):
    gx: torch.Tensor        # [B,T] all levels' x-gradients, flattened
    gy: torch.Tensor        # [B,T]
    offs: torch.Tensor      # [L] int64 level offsets into T
    hs: torch.Tensor        # [L] int64 level heights
    ws: torch.Tensor        # [L] int64 level widths
    ds: torch.Tensor        # [L] f32 downsample factors


def _grad_pyramid(img, num_octaves: int) -> _GradPyramid:
    """Octave-downsampled Gaussian gradient pyramid: level l = 2o+j carries
    smoothing 1.6 * 2^(l/2) at octave o's resolution. img [B,H,W]."""
    sigma0 = 1.6
    g = gaussian_blur(img, sigma0)
    gxs, gys, offs, hs, ws, dss = [], [], [], [], [], []
    off = 0
    for o in range(num_octaves):
        s2 = sigma0 * 2.0 ** 0.5
        g2 = gaussian_blur(g, float((s2 * s2 - sigma0 * sigma0) ** 0.5))
        for gl in (g, g2):
            gx = (torch.roll(gl, -1, -1) - torch.roll(gl, 1, -1)) * 0.5
            gy = (torch.roll(gl, -1, -2) - torch.roll(gl, 1, -2)) * 0.5
            h, w = gl.shape[-2:]
            gxs.append(gx.reshape(gx.shape[0], -1))
            gys.append(gy.reshape(gy.shape[0], -1))
            offs.append(off)
            hs.append(h)
            ws.append(w)
            dss.append(2 ** o)
            off += h * w
        if o + 1 < num_octaves:
            s4 = sigma0 * 2.0
            g = _downsample2(gaussian_blur(
                g2, float((s4 * s4 - s2 * s2) ** 0.5)))
    dev = img.device
    i64 = dict(dtype=torch.int64, device=dev)
    return _GradPyramid(torch.cat(gxs, 1), torch.cat(gys, 1),
                        torch.tensor(offs, **i64), torch.tensor(hs, **i64),
                        torch.tensor(ws, **i64),
                        torch.tensor(dss, dtype=torch.float32, device=dev))


def _sample_grad(pyr: _GradPyramid, lvl, uv, dx, dy):
    """Bilinear gradient taps at (uv/ds + (dx, dy)) on each keypoint's
    level, edge-clamped. lvl [B,K], uv [B,K,2], dx/dy [B,K,S] in LEVEL px.
    Returns (gx, gy) [B,K,S]."""
    off = pyr.offs[lvl][..., None]
    Hl = pyr.hs[lvl][..., None]
    Wl = pyr.ws[lvl][..., None]
    ds = pyr.ds[lvl][..., None]
    sx = uv[..., 0:1] / ds + dx
    sy = uv[..., 1:2] / ds + dy
    x0 = torch.minimum(sx.to(torch.int64), (Wl - 2).clamp_min(0)).clamp_min(0)
    fx = (sx - x0).clamp(0.0, 1.0)
    ry = torch.minimum(sy.clamp_min(0.0), (Hl - 1).to(sy.dtype))
    y0 = torch.minimum(ry.to(torch.int64), (Hl - 2).clamp_min(0)).clamp_min(0)
    fy = (ry - y0).clamp(0.0, 1.0)
    b, k, s = dx.shape
    base = off + y0 * Wl + x0

    def taps(atlas):
        def at(d):
            return torch.gather(atlas, 1, (base + d).reshape(b, -1)
                                ).reshape(b, k, s)
        top = at(0) * (1 - fx) + at(1) * fx
        bot = at(Wl) * (1 - fx) + at(Wl + 1) * fx
        return top * (1 - fy) + bot * fy

    return taps(pyr.gx), taps(pyr.gy)


def _orientation_batch(pyr, lvl, uv, scale):
    """Dominant orientations: (angle1, angle2, ratio2), each [B,K], from a
    16x16 sample grid (radius 8)."""
    dev = uv.device
    radius = 8
    d = torch.arange(-radius, radius, dtype=torch.float32, device=dev) + 0.5
    dyg, dxg = torch.meshgrid(d, d, indexing="ij")
    dxg = dxg.reshape(1, 1, -1)
    dyg = dyg.reshape(1, 1, -1)
    spacing = (scale / pyr.ds[lvl])[..., None]
    gx, gy = _sample_grad(pyr, lvl, uv, spacing * dxg, spacing * dyg)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    wgt = torch.exp(-0.5 * ((dxg ** 2 + dyg ** 2) /
                            (radius * radius / 2.25)))
    pos = (ang + math.pi) / (2 * math.pi) * 36.0 - 0.5
    b0 = torch.floor(pos)
    f = pos - b0
    b0i = b0.to(torch.int64) % 36
    b1i = (b0i + 1) % 36
    contrib = mag * wgt
    bins = torch.arange(36, device=dev)
    zero = torch.zeros((), device=dev)
    Wb = (torch.where(bins == b0i[..., None], (contrib * (1 - f))[..., None],
                      zero) +
          torch.where(bins == b1i[..., None], (contrib * f)[..., None],
                      zero))
    hist = Wb.sum(-2)                                     # [B,K,36]
    for _ in range(4):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0

    def take(h, idx):
        return torch.gather(h, -1, (idx % 36)[..., None])[..., 0]

    def refine(peak):
        hl = take(hist, peak - 1)
        hc = take(hist, peak)
        hr = take(hist, peak + 1)
        den = hl - 2 * hc + hr
        off = torch.where(den.abs() < 1e-12, torch.zeros_like(den),
                          (0.5 * (hl - hr) / den).clamp(-0.5, 0.5))
        return ((peak.to(torch.float32) + 0.5 + off) / 36.0 *
                2 * math.pi - math.pi)

    peak = hist.argmax(-1)
    near = torch.minimum((bins - peak[..., None]) % 36,
                         (peak[..., None] - bins) % 36) <= 1
    is_lmax = ((hist >= torch.roll(hist, 1, -1)) &
               (hist >= torch.roll(hist, -1, -1)))
    h2 = torch.where(near | ~is_lmax, torch.full_like(hist, -math.inf), hist)
    peak2 = h2.argmax(-1)
    h2p = take(h2, peak2)
    ratio2 = torch.where(torch.isfinite(h2p),
                         h2p / take(hist, peak).clamp_min(1e-12),
                         torch.zeros_like(h2p))
    return refine(peak), refine(peak2), ratio2


def _descriptor_batch(pyr, lvl, uv, scale, angle):
    """128-d SIFT-layout descriptors [B,K,128]."""
    dev = uv.device
    MAGNIF = 0.75
    g = torch.arange(16, dtype=torch.float32, device=dev) - 7.5
    gyg, gxg = torch.meshgrid(g, g, indexing="ij")
    gxg = gxg.reshape(1, 1, -1)
    gyg = gyg.reshape(1, 1, -1)
    ca = torch.cos(angle)[..., None]
    sa = torch.sin(angle)[..., None]
    spac = (MAGNIF * scale / pyr.ds[lvl])[..., None]
    dx = spac * (ca * gxg - sa * gyg)
    dy = spac * (sa * gxg + ca * gyg)
    gxi, gyi = _sample_grad(pyr, lvl, uv, dx, dy)
    gxv = ca * gxi + sa * gyi
    gyv = -sa * gxi + ca * gyi
    mag = torch.sqrt(gxv * gxv + gyv * gyv)
    ang = torch.atan2(gyv, gxv)
    wgt = torch.exp(-0.5 * ((gxg ** 2 + gyg ** 2) / 64.0))
    contrib = mag * wgt                                   # [B,K,S]

    opos = (ang + math.pi) / (2 * math.pi) * 8.0 - 0.5
    ob0 = torch.floor(opos)
    of = opos - ob0
    ob0 = ob0.to(torch.int64) % 8
    ob1 = (ob0 + 1) % 8
    obins = torch.arange(8, device=dev)
    zero = torch.zeros((), device=dev)
    O = (torch.where(obins == ob0[..., None], (contrib * (1 - of))[..., None],
                     zero) +
         torch.where(obins == ob1[..., None], (contrib * of)[..., None],
                     zero))                               # [B,K,S,8]

    cxpos = ((gxg + 6.0) / 4.0)[0, 0]                     # [S]
    cypos = ((gyg + 6.0) / 4.0)[0, 0]
    cx0 = torch.floor(cxpos)
    cy0 = torch.floor(cypos)
    fx = cxpos - cx0
    fy = cypos - cy0
    cx0 = cx0.to(torch.int64)
    cy0 = cy0.to(torch.int64)
    cb = torch.arange(4, device=dev)
    W4x = (torch.where(cb == cx0[:, None], (1.0 - fx)[:, None], zero) +
           torch.where(cb == cx0[:, None] + 1, fx[:, None], zero))
    W4y = (torch.where(cb == cy0[:, None], (1.0 - fy)[:, None], zero) +
           torch.where(cb == cy0[:, None] + 1, fy[:, None], zero))
    Wsp = (W4y[:, :, None] * W4x[:, None, :]).reshape(-1, 16)   # [S,16]
    desc = torch.einsum("sc,bkso->bkco", Wsp, O).reshape(
        *O.shape[:2], 128)
    n = torch.linalg.norm(desc, dim=-1, keepdim=True).clamp_min(1e-8)
    desc = torch.minimum(desc / n, torch.tensor(0.2, device=dev))
    return desc / torch.linalg.norm(desc, dim=-1,
                                    keepdim=True).clamp_min(1e-8)


def _dog_extrema(dogs, contrast_thresh: float, edge_ratio: float = 10.0):
    """Scale-space extrema of a DoG stack [B,S,H,W] on the middle scales:
    27-neighbourhood max/min INCLUDING the centre (ties admitted), contrast
    threshold, 2x2 Hessian edge rejection. Returns [B,S-2,H,W] |d| at
    accepted pixels, -inf elsewhere."""
    S = dogs.shape[1]

    def ext3(a, dim, op):
        return op(a, op(torch.roll(a, 1, dim), torch.roll(a, -1, dim)))

    mx9 = ext3(ext3(dogs, -2, torch.maximum), -1, torch.maximum)
    mn9 = ext3(ext3(dogs, -2, torch.minimum), -1, torch.minimum)
    resp = []
    r1 = (edge_ratio + 1.0) ** 2 / edge_ratio
    for s in range(1, S - 1):
        d = dogs[:, s]
        mx = torch.maximum(mx9[:, s], torch.maximum(mx9[:, s - 1],
                                                    mx9[:, s + 1]))
        mn = torch.minimum(mn9[:, s], torch.minimum(mn9[:, s - 1],
                                                    mn9[:, s + 1]))
        is_ext = (((d >= mx) & (d > contrast_thresh)) |
                  ((d <= mn) & (d < -contrast_thresh)))
        r = torch.roll
        dxx = r(d, -1, -1) + r(d, 1, -1) - 2 * d
        dyy = r(d, -1, -2) + r(d, 1, -2) - 2 * d
        dxy = (r(r(d, -1, -2), -1, -1) - r(r(d, -1, -2), 1, -1) -
               r(r(d, 1, -2), -1, -1) + r(r(d, 1, -2), 1, -1)) * 0.25
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        not_edge = (det > 0) & (tr * tr < r1 * det)
        resp.append(torch.where(is_ext & not_edge, d.abs(),
                                torch.full_like(d, -math.inf)))
    return torch.stack(resp, dim=1)


NUM_OCTAVES = 3          # DoG octaves (the JAX package's num_levels)
SCALES_PER_OCTAVE = 3
MIN_SCORE = 1e-7         # keypoints at or below this |DoG| are invalid


def detect_batch(grays, *, max_keypoints: int = 512,
                 margins: Tuple[float, float, float, float] = (0.0, 0.0,
                                                               0.0, 0.0)
                 ) -> Keypoints:
    """Detect up to K keypoints per image of grays [B,H,W] and describe
    them; every output has leading dim B. margins = (hl, hr, vl, vr)."""
    B, h, w = grays.shape
    dev = grays.device
    img = grays.to(torch.float32)
    img = img / img.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-8)
    hl, hr, vl, vr = margins
    K = max_keypoints
    sigma0 = 1.6
    kf = 2.0 ** (1.0 / SCALES_PER_OCTAVE)
    all_uv, all_score, all_scale = [], [], []
    base = gaussian_blur(img, sigma0)
    bidx = torch.arange(B, device=dev)[:, None]
    for octave in range(NUM_OCTAVES):
        oh, ow = base.shape[-2:]
        gs = [base]
        sig = sigma0
        for _ in range(SCALES_PER_OCTAVE + 2):
            gs.append(gaussian_blur(gs[-1],
                                    float(sig * (kf * kf - 1.0) ** 0.5)))
            sig *= kf
        dogs = torch.stack([gs[i + 1] - gs[i] for i in range(len(gs) - 1)],
                           dim=1)                         # [B,S,oh,ow]
        resp = _dog_extrema(dogs, contrast_thresh=0.005)
        mm = margin_mask(oh, ow, hl, hr, vl, vr, device=dev)
        mm = mm * margin_mask(oh, ow, 8.0 / ow, 8.0 / ow, 8.0 / oh,
                              8.0 / oh, device=dev)
        resp = torch.where(mm > 0, resp, torch.full_like(resp, -math.inf))
        score, flat = torch.topk(resp.reshape(B, -1), K, dim=-1)
        per = oh * ow
        sflat = flat % per
        sidx = flat // per
        ui = sflat % ow
        vi = sflat // ow
        ssel = (sidx + 1).clamp(0, dogs.shape[1] - 1)

        def at(dy, dx):
            yy = (vi + dy).clamp(0, oh - 1)
            xx = (ui + dx).clamp(0, ow - 1)
            return dogs[bidx, ssel, yy, xx].abs()

        gx = 0.5 * (at(0, 1) - at(0, -1))
        gy = 0.5 * (at(1, 0) - at(-1, 0))
        hxx = at(0, 1) + at(0, -1) - 2 * at(0, 0)
        hyy = at(1, 0) + at(-1, 0) - 2 * at(0, 0)
        hxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
        det = hxx * hyy - hxy * hxy
        det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12),
                          det)
        offx = (-(hyy * gx - hxy * gy) / det).clamp(-0.5, 0.5)
        offy = (-(hxx * gy - hxy * gx) / det).clamp(-0.5, 0.5)
        uu = (ui.to(torch.float32) + offx) * (2.0 ** octave)
        vv = (vi.to(torch.float32) + offy) * (2.0 ** octave)
        all_uv.append(torch.stack([uu, vv], -1))
        all_score.append(score)

        def at_s(dsc):
            ss = (sidx + 1 + dsc).clamp(0, dogs.shape[1] - 1)
            return dogs[bidx, ss, vi, ui].abs()

        gs1 = 0.5 * (at_s(1) - at_s(-1))
        hss = at_s(1) + at_s(-1) - 2 * at_s(0)
        hss = torch.where(hss.abs() < 1e-12, torch.full_like(hss, -1e-12),
                          hss)
        offs = (-gs1 / hss).clamp(-0.5, 0.5)
        lvl_sigma = sigma0 * (kf ** (sidx.to(torch.float32) + 1.0 + offs))
        all_scale.append(lvl_sigma / sigma0 * (2.0 ** octave))
        if octave + 1 < NUM_OCTAVES:
            base = _downsample2(gs[SCALES_PER_OCTAVE])

    uv = torch.cat(all_uv, 1)
    score = torch.cat(all_score, 1)
    scale = torch.cat(all_scale, 1)
    score_top, sel = torch.topk(score, K, dim=-1)
    uv = torch.gather(uv, 1, sel[..., None].expand(-1, -1, 2))
    scale = torch.gather(scale, 1, sel)

    n_glv = 2 * NUM_OCTAVES
    pyr = _grad_pyramid(img, NUM_OCTAVES)
    glvl = _grad_level(scale, n_glv)
    ang1, ang2, ratio2 = _orientation_batch(pyr, glvl, uv, scale)
    score2 = torch.where(ratio2 >= 0.8, score_top * (1.0 - 1e-6),
                         torch.full_like(score_top, -math.inf))
    uv = torch.cat([uv, uv], 1)
    scale = torch.cat([scale, scale], 1)
    ang = torch.cat([ang1, ang2], 1)
    score_top, sel = torch.topk(torch.cat([score_top, score2], 1), K, dim=-1)
    uv = torch.gather(uv, 1, sel[..., None].expand(-1, -1, 2))
    scale = torch.gather(scale, 1, sel)
    ang = torch.gather(ang, 1, sel)
    valid = torch.isfinite(score_top) & (score_top > MIN_SCORE)
    glvl = _grad_level(scale, n_glv)
    desc = _descriptor_batch(pyr, glvl, uv, scale, ang)
    desc = torch.where(valid[..., None], desc, torch.zeros_like(desc))
    return Keypoints(uv, scale, ang, score_top, valid, desc)


def detect_and_describe(gray, **kw) -> Keypoints:
    """Detect and describe one image [H,W] (see ``detect_batch``)."""
    kp = detect_batch(gray[None], **kw)
    return Keypoints(*(x[0] for x in kp))
