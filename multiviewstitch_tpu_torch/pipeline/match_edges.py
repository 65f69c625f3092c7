"""Batched all-pairs matching front-end over view-graph edges.

PyTorch counterpart of ``multiviewstitch_tpu/pipeline/match_edges.py``:
every (frame_i, frame_j) edge of a sequence pair is processed at once,
with the edge axis written out as a batch dimension — descriptor matching,
texIndex mapping, dedup, SSD, gap-NMS, 3D lift and the adaptive RANSAC
cascade — and keyframe selection plus the final solve pull one small
result to the host.

RANSAC draws each edge's hypotheses from the counter-based stream of
``solvers/srt`` keyed by (seed, sequence pair, edge id), as the JAX package
keys them by ``fold_in(key, edge_id)``: an edge's result does not depend
on which other edges share its batch, so the edge-sharded sweep
(``parallel/match_dist``) equals this one bit for bit. The bits differ
from JAX's threefry, so results agree with it in distribution.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import StitchConfig
from ..core.cameras import CameraBatch, unproject_depth_map
from ..ops.features import detect_batch
from ..ops.filters import dedup_matches, ssd_filter, gap_filter
from ..ops.match import match_descriptors
from ..ops.segmentation import foreground_from_disparity
from ..ops.view_synth import synthesize_views, view_angles
from ..solvers.srt import (FINAL_ROUND, RansacStream, estimate_srt_ransac,
                           remove_outliers)
from ..utils.profiling import count


class SequencePrep(NamedTuple):
    """Per-sequence state shared by every edge."""
    desc: torch.Tensor      # [N,V,K,128]
    kp_valid: torch.Tensor  # [N,V,K]
    kp_uv: torch.Tensor     # [N,V,K,2]
    tex: torch.Tensor       # [N,V,H,W] int32 texIndex -> source pixel
    gray: torch.Tensor      # [N,H,W]
    pts: torch.Tensor       # [N,H,W,3] unprojected world points
    pmask: torch.Tensor     # [N,H,W] valid-depth mask
    cams: CameraBatch       # batch N


class EdgeBatch(NamedTuple):
    """Per-edge match state for all E = n1*n2 frame pairs."""
    edge_i: torch.Tensor      # [E] frame index in sequence 1
    edge_j: torch.Tensor      # [E] frame index in sequence 2
    uv1: torch.Tensor         # [E,M,2] source-pixel coords
    uv2: torch.Tensor
    p1: torch.Tensor          # [E,M,3]
    p2: torch.Tensor
    mask: torch.Tensor        # [E,M] surviving inlier mask
    residual: torch.Tensor    # [E] keyframe-selection residual (inf if bad)
    num_matches: torch.Tensor  # [E] surviving match count


def _margins(cfg: StitchConfig):
    return (float(cfg.hl_margin_ratio), float(cfg.hr_margin_ratio),
            float(cfg.vl_margin_ratio), float(cfg.vr_margin_ratio))


def prep_sequence(seq, cfg: StitchConfig) -> SequencePrep:
    """Foreground mask (``segment``), virtual views, SIFT features and
    unprojection maps of one sequence."""
    gray, cams = seq.gray, seq.cams
    g = gray    # features see the masked frames, the SSD filter the raw ones
    if cfg.segment:
        fg = foreground_from_disparity(seq.disparity, cfg.min_dsp,
                                       cfg.max_dsp)
        g = torch.where(fg, gray, torch.zeros_like(gray))
    n, h, w = gray.shape
    v = int(cfg.view_count)
    angles = view_angles(v, float(cfg.rot_angle), device=gray.device)
    views, texs = [], []
    for i in range(n):
        sv = synthesize_views(g[i][..., None], cams.K[i], cams.R[i],
                              angles, axis=int(cfg.axis))
        views.append(sv.images[..., 0])
        texs.append(sv.tex_index)
    flat = torch.stack(views).reshape(n * v, h, w)
    kp = detect_batch(flat, max_keypoints=int(cfg.max_keypoints),
                      margins=_margins(cfg))
    kp = type(kp)(*(x.reshape(n, v, *x.shape[1:]) for x in kp))
    pts, pmask = unproject_depth_map(cams, seq.disparity, cfg.min_dsp,
                                     cfg.max_dsp)
    return SequencePrep(kp.desc, kp.valid, kp.uv, torch.stack(texs), gray,
                        pts, pmask, cams)


def _pixel_take(img, ei, uv):
    """img [N,H,W(,C)] at frames ei [E] and integer pixels uv [E,M,2]."""
    h, w = img.shape[1:3]
    flat = img[ei].reshape(ei.shape[0], h * w, *img.shape[3:])
    idx = (uv[..., 1] * w + uv[..., 0]).long()
    if flat.dim() == 3:
        idx = idx[..., None].expand(*idx.shape, flat.shape[-1])
    return torch.gather(flat, 1, idx)


def match_edges(prep1: SequencePrep, prep2: SequencePrep, key: int, *,
                view_count: int, distmax, ratiomax, ssd_win: int, ssd_err,
                min_gap_sq, pixel_err, adapt_ratio, iter_num: int,
                rounds: int) -> EdgeBatch:
    """All n1*n2 frame-pair edges as one batch (Processor.cpp:644-744 and
    RemoveOutliers, 177-259); edge e = i*n2 + j draws from ``key``'s
    stream at edge id e."""
    n2 = prep2.gray.shape[0]
    eid = torch.arange(prep1.gray.shape[0] * n2, device=prep1.gray.device)
    out = match_edge_block(prep1, prep2, key, eid // n2, eid % n2, eid,
                           view_count=view_count, distmax=distmax,
                           ratiomax=ratiomax, ssd_win=ssd_win,
                           ssd_err=ssd_err, min_gap_sq=min_gap_sq,
                           pixel_err=pixel_err, adapt_ratio=adapt_ratio,
                           iter_num=iter_num, rounds=rounds)
    return EdgeBatch(eid // n2, eid % n2, *out)


def match_edge_block(prep1: SequencePrep, prep2: SequencePrep, key: int,
                     ei, ej, eid, *, view_count: int, distmax, ratiomax,
                     ssd_win: int, ssd_err, min_gap_sq, pixel_err,
                     adapt_ratio, iter_num: int, rounds: int):
    """The edges (ei, ej) [B] with stream edge ids ``eid`` [B]: returns
    (uv1, uv2, p1, p2, mask, residual, num_matches), each with leading
    dim B, as in EdgeBatch (counter ``sweep.edges``)."""
    dev = prep1.gray.device
    count("sweep.edges", eid.shape[0])
    h, w = prep1.gray.shape[-2:]
    lim = torch.tensor([w - 1, h - 1], device=dev)

    uv1_all, uv2_all, ok_all = [], [], []
    for vi in range(view_count):
        for vj in range(view_count):
            m = match_descriptors(
                prep1.desc[ei, vi], prep1.kp_valid[ei, vi],
                prep2.desc[ej, vj], prep2.kp_valid[ej, vj],
                distmax=distmax, ratiomax=ratiomax)
            kuv1 = prep1.kp_uv[ei, vi]
            kuv2 = torch.gather(prep2.kp_uv[ej, vj], 1,
                                m.idx2[..., None].expand(-1, -1, 2))
            iu1 = torch.minimum(kuv1.to(torch.int64).clamp_min(0), lim)
            iu2 = torch.minimum(kuv2.to(torch.int64).clamp_min(0), lim)
            t1 = _pixel_take(prep1.tex[:, vi], ei, iu1)
            t2 = _pixel_take(prep2.tex[:, vj], ej, iu2)
            ok_all.append(m.valid & (t1 >= 0) & (t2 >= 0))
            uv1_all.append(torch.stack([t1 % w, t1 // w], -1))
            uv2_all.append(torch.stack([t2 % w, t2 // w], -1))
    uv1 = torch.cat(uv1_all, 1)
    uv2 = torch.cat(uv2_all, 1)
    ok = torch.cat(ok_all, 1)

    uv1, uv2, ok = dedup_matches(uv1, uv2, ok)
    ok = ssd_filter(prep1.gray[ei], prep2.gray[ej], uv1, uv2, ok,
                    win=ssd_win, ssd_err=ssd_err)
    ok = gap_filter(uv1, uv2, ok, min_gap_sq=min_gap_sq)

    cu1 = torch.minimum(uv1.clamp_min(0), lim)
    cu2 = torch.minimum(uv2.clamp_min(0), lim)
    p1 = _pixel_take(prep1.pts, ei, cu1)
    p2 = _pixel_take(prep2.pts, ej, cu2)
    ok = ok & _pixel_take(prep1.pmask, ei, cu1) & _pixel_take(
        prep2.pmask, ej, cu2)

    # edges with < 3 lifted matches are ineligible (Processor.cpp:746):
    # solve on a placeholder mask and invalidate the outputs
    eligible = ok.sum(-1) >= 3
    first3 = torch.arange(ok.shape[1], device=dev) < 3
    safe = torch.where(eligible[:, None], ok, first3.expand_as(ok))
    mask, _, res = remove_outliers(
        p1, p2, safe, prep1.cams[ei], prep2.cams[ej], RansacStream(key, eid),
        pixel_err=pixel_err, adapt_ratio=adapt_ratio, iter_num=iter_num,
        rounds=rounds)
    mask = mask & eligible[:, None]
    res = torch.where(eligible, res, torch.full_like(res, float("inf")))
    return uv1, uv2, p1, p2, mask, res, mask.sum(-1)


def edge_knobs(cfg: StitchConfig) -> dict:
    """The match_edges keyword set derived from a StitchConfig."""
    return dict(view_count=cfg.view_count, distmax=cfg.distmax,
                ratiomax=cfg.ratiomax, ssd_win=cfg.ssd_win,
                ssd_err=cfg.ssd_err,
                min_gap_sq=float(cfg.sample_interval) ** 2,
                pixel_err=cfg.pixel_err,
                adapt_ratio=cfg.adapt_pixel_err_ratio,
                iter_num=cfg.iter_num, rounds=cfg.ransac_rounds)


def select_and_solve(edges: EdgeBatch, cams1: CameraBatch,
                     cams2: CameraBatch, key: int, *,
                     min_match_count: int, iter_num: int):
    """Keyframe selection (min residual among edges with >= min_match_count
    surviving matches, Processor.cpp:750-765) and the final SRT solve on
    the winning edge (``key``'s stream at that edge, round FINAL_ROUND).
    Returns (ok, best_e, nm [E], res [E], T), all on the host (T as
    float32 CPU tensors)."""
    nm = edges.num_matches
    res = edges.residual
    elig = nm >= min_match_count
    scored = torch.where(elig, res, torch.full_like(res, float("inf")))
    best_e = int(scored.argmin())
    fi = int(edges.edge_i[best_e])
    fj = int(edges.edge_j[best_e])
    stream = RansacStream(key, torch.tensor(best_e, device=res.device))
    T, _ = estimate_srt_ransac(
        edges.p1[best_e], edges.p2[best_e], edges.mask[best_e], cams1[fi],
        cams2[fj], stream, iter_num=iter_num, round_=FINAL_ROUND)
    return (bool(elig.any()), best_e, nm.cpu(), res.cpu(), T.to("cpu"))
