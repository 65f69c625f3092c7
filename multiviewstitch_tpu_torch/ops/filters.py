"""Match-filter cascade: dedup, photometric SSD, pixel-gap NMS.

PyTorch counterpart of ``multiviewstitch_tpu/ops/filters.py`` (the
reference's serial filter chain, Processor.cpp:644-744). Every function
takes fixed-capacity match buffers with validity masks and accepts any
leading batch dims (the edge axis of the sweep).
"""

from __future__ import annotations

import torch

from ..utils.profiling import count

def dedup_matches(uv1, uv2, mask):
    """Mark duplicate (uv1, uv2) integer pixel pairs invalid, keeping one
    representative each, and return matches sorted by (u1, v1, u2, v2)
    (the iteration order of the reference's std::set). uv1/uv2 [...,M,2]
    int; mask [...,M] bool. Returns (uv1, uv2, mask) sorted."""
    stride = 16384
    big = 2 ** 31 - 1
    ka = (uv1[..., 0] * stride + uv1[..., 1]).to(torch.int64)
    kb = (uv2[..., 0] * stride + uv2[..., 1]).to(torch.int64)
    ka = torch.where(mask, ka, torch.full_like(ka, big))
    kb = torch.where(mask, kb, torch.full_like(kb, big))
    # lexicographic (ka, kb) as one exact int64 key, stable like lexsort
    order = torch.sort(ka * (2 ** 31) + kb, dim=-1, stable=True).indices
    ka_s = torch.gather(ka, -1, order)
    kb_s = torch.gather(kb, -1, order)
    first = torch.ones_like(mask)
    first[..., 1:] = ((ka_s[..., 1:] != ka_s[..., :-1]) |
                      (kb_s[..., 1:] != kb_s[..., :-1]))
    new_mask = (ka_s != big) & first
    o2 = order[..., None].expand(*order.shape, 2)
    return (torch.gather(uv1, -2, o2), torch.gather(uv2, -2, o2), new_mask)


def _gather_patch(gray, uv, win: int):
    """[...,M,(2win+1)^2] windows of gray [...,H,W] around integer centres
    uv [...,M,2] (clamped)."""
    h, w = gray.shape[-2:]
    d = torch.arange(-win, win + 1, device=gray.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    px = (uv[..., 0, None] + dx.reshape(-1)).clamp(0, w - 1)
    py = (uv[..., 1, None] + dy.reshape(-1)).clamp(0, h - 1)
    flat = (py * w + px).to(torch.int64)
    g = gray.reshape(*gray.shape[:-2], -1)
    return torch.gather(g, -1, flat.reshape(*flat.shape[:-2], -1)).reshape(
        flat.shape)


def ssd_filter(gray1, gray2, uv1, uv2, mask, *, win: int, ssd_err: float):
    """Photometric filter: RMS gray difference over the window <= ssd_err,
    window fully inside both images (0..255 gray scale)."""
    h, w = gray1.shape[-2:]
    inb = ((uv1 >= win).all(-1) & (uv2 >= win).all(-1) &
           (uv1[..., 0] < w - win) & (uv1[..., 1] < h - win) &
           (uv2[..., 0] < w - win) & (uv2[..., 1] < h - win))
    diff = _gather_patch(gray1, uv1, win) - _gather_patch(gray2, uv2, win)
    rms = torch.sqrt((diff * diff).mean(-1))
    return mask & inb & (rms <= ssd_err)


def gap_filter(uv1, uv2, mask, *, min_gap_sq: float):
    """Greedy sequential spacing filter (Processor.cpp:711-735): scan matches
    in order; keep one iff neither endpoint lies within sqrt(min_gap_sq) px
    of ANY previously kept match's corresponding endpoint.

    Exact greedy semantics, computed in parallel rounds over the whole
    [...,M,M] conflict matrix: a candidate is KEPT once no earlier live
    candidate conflicts with it, and DROPPED once an earlier kept one does.
    Each round settles at least the earliest undecided candidate, so the
    loop ends after at most M rounds (a handful on real match sets); one
    host sync per round (counter ``sweep.gap_rounds``)."""
    f1 = uv1.to(torch.float32)
    f2 = uv2.to(torch.float32)
    d1 = ((f1[..., :, None, :] - f1[..., None, :, :]) ** 2).sum(-1)
    d2 = ((f2[..., :, None, :] - f2[..., None, :, :]) ** 2).sum(-1)
    m = mask.shape[-1]
    earlier = torch.ones((m, m), dtype=torch.bool,
                         device=mask.device).tril(-1)     # [i, j]: j < i
    confl = ((d1 <= min_gap_sq) | (d2 <= min_gap_sq)) & earlier
    kept = torch.zeros_like(mask)
    undecided = mask.clone()
    rounds = 0
    while bool(undecided.any()):
        rounds += 1
        blocked = (confl & kept[..., None, :]).any(-1)
        undecided = undecided & ~blocked
        waiting = (confl & undecided[..., None, :]).any(-1)
        newly = undecided & ~waiting
        kept = kept | newly
        undecided = undecided & ~newly
    count("sweep.gap_rounds", rounds)
    return kept


def margin_mask(height: int, width: int, hl: float, hr: float, vl: float,
                vr: float, *, device):
    """[H,W] multiplicative mask zeroing the detection margins (the
    reference blanks these bands before SIFT, FeatureProc.cpp:28-43)."""
    u = torch.arange(width, device=device)
    v = torch.arange(height, device=device)
    um = (u >= hl * width) & (u < width * (1.0 - hr))
    vm = (v >= vl * height) & (v < height * (1.0 - vr))
    return (vm[:, None] & um[None, :]).to(torch.float32)
