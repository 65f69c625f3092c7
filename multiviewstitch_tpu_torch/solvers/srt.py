"""Similarity-transform (s, R, t) estimation: batched Kabsch + RANSAC.

PyTorch counterpart of ``multiviewstitch_tpu/solvers/srt.py``
(SRTSolver of the reference). Every function accepts leading batch dims
(the edge axis of the sweep): p1/p2 [...,M,3], mask [...,M], cameras with
batch [...].

RANSAC is split in two so the scorer can be held against the JAX package
on the same hypotheses: ``sample_triples`` draws index triples (top-3 of
the stream's 32-bit draws over the valid mask: uniform sampling without
replacement), and ``estimate_srt_from_triples`` scores them.

The random stream is counter-based: a match's draw is an integer hash
of (seed, sequence pair, edge id, round, hypothesis, match), so an edge
draws the same hypotheses whatever other edges share its batch, on any
rank of a sharded sweep and on the CPU and the card alike (the role of the
JAX package's ``fold_in(key, edge_id)`` threefry keys; the bits differ
from JAX's).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.cameras import CameraBatch, project
from ..core.transforms import Similarity

_EPS = 1e-12


def _masked_mean(x, mask, dim=None):
    m = mask.to(x.dtype)
    return (x * m).sum(dim) / m.sum(dim).clamp_min(1.0)


def _masked_median(x, mask, dim=-1):
    """Median over valid entries along ``dim`` (invalid sorted to +inf;
    averages the two middles)."""
    mask = torch.broadcast_to(mask, x.shape)
    size = x.shape[dim]
    n = mask.sum(dim).clamp_min(1)
    r = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))),
                   dim=dim).values
    lo = ((n - 1) // 2).clamp(0, size - 1)
    hi = (n // 2).clamp(0, size - 1)
    rlo = torch.gather(r, dim, lo.unsqueeze(dim))
    rhi = torch.gather(r, dim, hi.unsqueeze(dim))
    return (0.5 * (rlo + rhi)).squeeze(dim)


def estimate_scale(p1, p2, mask):
    """Ratio of distances to barycenters, aggregated by two MAD-gated
    passes (masked median pilot, then the mean over gated inliers), like
    the JAX package. p1/p2 [...,M,3], mask [...,M] -> [...]."""
    def ratios(m):
        c1 = _masked_mean(p1, m[..., None], dim=-2)
        c2 = _masked_mean(p2, m[..., None], dim=-2)
        d1 = torch.linalg.norm(p1 - c1[..., None, :], dim=-1)
        d2 = torch.linalg.norm(p2 - c2[..., None, :], dim=-1)
        return d2 / d1.clamp_min(_EPS)

    def gated(ratio, m):
        pilot = _masked_median(ratio, m)
        mad = _masked_median((ratio - pilot[..., None]).abs(), m)
        return m & ((ratio - pilot[..., None]).abs() <=
                    torch.maximum(5.0 * mad, 1e-3 * pilot.abs())[..., None])

    gate = gated(ratios(mask), mask)
    ratio2 = ratios(gate)
    gate2 = gated(ratio2, gate)
    return _masked_mean(ratio2, gate2, dim=-1)


def kabsch_rt(p1, p2, weights, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Kabsch: R, t minimizing |s R p1 + t - p2| (batched over
    leading dims; det-reflection fix)."""
    w = weights[..., :, None]
    wsum = w.sum(-2, keepdim=True).clamp_min(_EPS)
    c1 = (p1 * w).sum(-2, keepdim=True) / wsum
    c2 = (p2 * w).sum(-2, keepdim=True) / wsum
    scale = torch.as_tensor(scale, dtype=p1.dtype, device=p1.device)
    X = (p1 - c1) * scale[..., None, None]
    Y = p2 - c2
    S = torch.einsum("...ni,...nj->...ij", X * w, Y)
    U, _, Vt = torch.linalg.svd(S)
    V = Vt.transpose(-1, -2)
    det = torch.linalg.det(torch.einsum("...ij,...kj->...ik", V, U))
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = torch.einsum("...ij,...j,...kj->...ik", V, D, U)
    t = c2[..., 0, :] - scale[..., None] * torch.einsum(
        "...ij,...j->...i", R, c1[..., 0, :])
    return R, t


def _round_px(x):
    return torch.floor(x + 0.5)


def per_match_errors(T: Similarity, p1, p2, cam1: CameraBatch,
                     cam2: CameraBatch):
    """Both directional pixel errors per match: ([...,M], [...,M]).
    T and the cameras carry the leading batch dims of p1/p2 minus M."""
    s = T.s[..., None, None]
    fwd = s * torch.einsum("...ij,...nj->...ni", T.R, p1) + T.t[..., None, :]
    c2 = cam2.expand_dims(1)
    c1 = cam1.expand_dims(1)
    uv_f, _ = project(c2, fwd)
    uv_2, _ = project(c2, p2)
    e1 = torch.linalg.norm(_round_px(uv_f) - _round_px(uv_2), dim=-1)
    bwd = (1.0 / s) * torch.einsum("...ji,...nj->...ni", T.R,
                                   p2 - T.t[..., None, :])
    uv_b, _ = project(c1, bwd)
    uv_1, _ = project(c1, p1)
    e2 = torch.linalg.norm(_round_px(uv_b) - _round_px(uv_1), dim=-1)
    return e1, e2


def residual_error(T: Similarity, p1, p2, mask, cam1, cam2):
    """Symmetric mean pixel reprojection error over the masked matches."""
    e1, e2 = per_match_errors(T, p1, p2, cam1, cam2)
    return _masked_mean(0.5 * (e1 + e2), mask, dim=-1)


_M32 = 0xFFFFFFFF
# the round of the final solve on the chosen edge (select_and_solve)
FINAL_ROUND = 0xFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    in 16-bit halves so no product leaves int64's range."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _hash32(x):
    """A bijective 32-bit integer mix (lowbias32) on int64 tensors (or
    Python ints) holding 32-bit values."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def stream_key(seed: int, pair: int) -> int:
    """The 32-bit stream key of one sequence pair's sweep."""
    return int(_hash32(_hash32(int(seed) & _M32) ^ (int(pair) & _M32)))


class RansacStream(NamedTuple):
    """The random stream of a batch of RANSAC problems: the sweep's key
    and each problem's edge id (int64, the problems' batch shape)."""
    key: int
    edge: torch.Tensor


def stream_bits(stream: RansacStream, round_: int, n_hyp: int, m: int):
    """[*edge.shape, n_hyp, m] int64 32-bit hashes of (key, edge, round,
    hypothesis, match); within one (edge, round, hypothesis) all m differ."""
    e = _hash32(stream.edge.to(torch.int64) ^ stream.key)
    e = _hash32(e ^ (int(round_) & _M32))
    dev = stream.edge.device
    k = _hash32(e[..., None] ^ torch.arange(n_hyp, device=dev))
    j = _mul32(torch.arange(m, device=dev), 0x9E3779B9)
    return _hash32(k[..., None] ^ j)


def sample_triples(mask, iter_num: int, stream: RansacStream, round_: int):
    """[...,iter_num,3] int64 indices: per hypothesis, 3 distinct valid
    matches drawn uniformly, as the top 3 of the stream's 32-bit draws
    over the valid mask (the draws of one hypothesis all differ, so no tie
    is left to the sort)."""
    bits = stream_bits(stream, round_, iter_num, mask.shape[-1])
    g = torch.where(mask[..., None, :], bits, torch.full_like(bits, -1))
    return torch.topk(g, 3, dim=-1).indices


def estimate_srt_from_triples(p1, p2, mask, cam1: CameraBatch,
                              cam2: CameraBatch, idx):
    """Score the hypotheses of idx [...,K,3]: scale from all matches,
    Kabsch per triple, selection by least median of the per-match
    symmetric pixel errors. Returns (best Similarity [...], its mean
    residual [...])."""
    scale = estimate_scale(p1, p2, mask)                  # [...]
    k = idx.shape[-2]
    gi = idx.reshape(*idx.shape[:-2], -1)[..., None].expand(
        *idx.shape[:-2], k * 3, 3)
    q1 = torch.gather(p1, -2, gi).reshape(*idx.shape, 3)  # [...,K,3,3]
    q2 = torch.gather(p2, -2, gi).reshape(*idx.shape, 3)
    R, t = kabsch_rt(q1, q2, torch.ones(q1.shape[:-1], dtype=p1.dtype,
                                        device=p1.device),
                     scale[..., None].expand(*scale.shape, k))
    Ts = Similarity(scale[..., None].expand(*scale.shape, k), R, t)
    e1, e2 = per_match_errors(Ts, p1[..., None, :, :], p2[..., None, :, :],
                              cam1.expand_dims(1), cam2.expand_dims(1))
    per = 0.5 * (e1 + e2)                                 # [...,K,M]
    per = torch.where(mask[..., None, :], per,
                      torch.full_like(per, float("inf")))
    m = mask.shape[-1]
    m_valid = mask.sum(-1).clamp_min(1)
    srt = torch.sort(per, dim=-1).values
    mid = ((m_valid - 1) // 2).clamp(0, m - 1)
    med = torch.gather(srt, -1, mid[..., None, None].expand(
        *mid.shape, k, 1))[..., 0]                        # [...,K]
    best = med.argmin(-1)                                 # [...]
    bi = best[..., None]
    best_T = Similarity(
        torch.gather(Ts.s, -1, bi)[..., 0],
        torch.gather(R, -3, bi[..., None, None].expand(*best.shape, 1, 3, 3)
                     )[..., 0, :, :],
        torch.gather(t, -2, bi[..., None].expand(*best.shape, 1, 3)
                     )[..., 0, :])
    return best_T, residual_error(best_T, p1, p2, mask, cam1, cam2)


def estimate_srt_ransac(p1, p2, mask, cam1: CameraBatch, cam2: CameraBatch,
                        stream: RansacStream, *, iter_num: int = 200,
                        round_: int = 0):
    """RANSAC similarity solve, all hypotheses batched, drawn from round
    ``round_`` of ``stream``."""
    idx = sample_triples(mask, iter_num, stream, round_)
    return estimate_srt_from_triples(p1, p2, mask, cam1, cam2, idx)


def remove_outliers(p1, p2, mask, cam1: CameraBatch, cam2: CameraBatch,
                    stream: RansacStream, *, pixel_err: float,
                    adapt_ratio: float, iter_num: int = 200,
                    rounds: int = 3):
    """The reference's adaptive outlier pruning (Processor.cpp:177-259):
    ``rounds`` rounds of {RANSAC fit -> drop matches whose either pixel
    error exceeds pixel_err * ratio}, ratio shrinking by adapt_ratio;
    round r draws round r of ``stream``. Returns (mask, T, residual)."""
    ratio = 1.0
    T, res = None, None
    for r in range(rounds):
        T, res = estimate_srt_ransac(p1, p2, mask, cam1, cam2, stream,
                                     iter_num=iter_num, round_=r)
        e1, e2 = per_match_errors(T, p1, p2, cam1, cam2)
        thr = pixel_err * ratio
        new_mask = mask & (e1 <= thr) & (e2 <= thr)
        # keep pruning only while >= 3 matches remain (Processor.cpp:258)
        mask = torch.where((new_mask.sum(-1) >= 3)[..., None], new_mask,
                           mask)
        ratio = ratio * adapt_ratio
    return mask, T, res
