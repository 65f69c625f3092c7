"""Sequence alignment pipeline: AlignmentSeq in PyTorch.

PyTorch counterpart of ``multiviewstitch_tpu/pipeline/align_seq.py``
(Processor::AlignmentSeq + CalcSimilarityTransformationSeq,
Processor.cpp:835-1106): per-sequence prep -> per-pair edge sweep ->
keyframe selection + SRT solve -> greedy left-compose chain; then
consistency check (K1) -> oriented point sampler (K2) -> visibility
filter -> transform into the reference frame.

Not ported yet: ``refine`` (pose graph / bundle adjustment), ``all_pairs``,
the sharded sweep and the debug match dumps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from ..config import StitchConfig
from ..core.cameras import CameraBatch
from ..core.transforms import Similarity
from ..ops.consistency import check_consistency
from ..ops.point_sampling import sample_oriented_points, visibility_filter


@dataclass
class Sequence:
    """One RGB-D sequence: gray [N,H,W] (0..255), disparity [N,H,W],
    cameras (batch N)."""
    gray: torch.Tensor
    disparity: torch.Tensor
    cams: CameraBatch


@dataclass
class PairCandidate:
    frame_i: int
    frame_j: int
    residual: float
    num_matches: int


@dataclass
class AlignResult:
    transforms: List[Similarity]      # per sequence -> final frame (CPU)
    keyframes: List[Tuple[int, int]]  # chosen (frame_i, frame_j) per pair
    residuals: List[float]


def match_sequence_pair(seq1: Sequence, seq2: Sequence, cfg: StitchConfig,
                        generator: torch.Generator, prep1=None, prep2=None
                        ) -> Tuple[Similarity, PairCandidate]:
    """Best keyframe pair between two sequences and its SRT (the per-pair
    body of CalcSimilarityTransformationSeq, Processor.cpp:629-833)."""
    from .match_edges import (prep_sequence, match_edges, edge_knobs,
                              select_and_solve)
    n2 = seq2.gray.shape[0]
    if prep1 is None:
        prep1 = prep_sequence(seq1, cfg)
    if prep2 is None:
        prep2 = prep_sequence(seq2, cfg)
    eb = match_edges(prep1, prep2, generator, **edge_knobs(cfg))
    ok_any, best_e, nm, res, T = select_and_solve(
        eb, seq1.cams, seq2.cams, generator,
        min_match_count=cfg.min_match_count, iter_num=cfg.iter_num)
    if not ok_any:
        raise RuntimeError(
            f"no frame pair with >= {cfg.min_match_count} matches "
            f"(best had {int(nm.max())}) — cannot align sequences "
            "(Processor.cpp:794-800 analogue)")
    return T, PairCandidate(best_e // n2, best_e % n2, float(res[best_e]),
                            int(nm[best_e]))


def _compose_host(A: Similarity, B: Similarity) -> Similarity:
    """compose() on float32 CPU tensors: s = sA*sB, R = RA@RB,
    t = sA*RA@tB + tA (Processor.cpp:819-823)."""
    return Similarity(A.s * B.s, A.R @ B.R, A.s * (A.R @ B.t) + A.t)


def align_sequences(seqs: List[Sequence], cfg: StitchConfig,
                    seed: int = 0, preps=None) -> AlignResult:
    """Chain all sequences into the last sequence's frame (greedy chain,
    the reference's behaviour, Processor.cpp:813-826); RANSAC draws from
    one torch.Generator seeded with ``seed``. ``preps``: the sequences'
    ``prep_sequence`` results, if already computed."""
    from .match_edges import prep_sequence
    dev = seqs[0].gray.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if preps is None:
        preps = [prep_sequence(s, cfg) for s in seqs]
    edges, keyframes, residuals = [], [], []
    for k in range(len(seqs) - 1):
        T, best = match_sequence_pair(seqs[k], seqs[k + 1], cfg, gen,
                                      preps[k], preps[k + 1])
        edges.append(T)
        keyframes.append((best.frame_i, best.frame_j))
        residuals.append(best.residual)
    transforms = []
    for k in range(len(seqs)):
        acc = Similarity.identity(device="cpu")
        for j in range(k, len(edges)):
            acc = _compose_host(edges[j], acc)
        transforms.append(acc)
    return AlignResult(transforms, keyframes, residuals)


def _fuse_one(points, valid_in, normals, cams: CameraBatch, T: Similarity):
    """Visibility filter + similarity transform of one sequence's samples."""
    valid = visibility_filter(points.reshape(-1, 3), valid_in.reshape(-1),
                              cams)
    pts = T.s * torch.einsum("ij,nj->ni", T.R, points.reshape(-1, 3)) + T.t
    nrm = torch.einsum("ij,nj->ni", T.R, normals.reshape(-1, 3))
    return pts, nrm, valid


def fuse_sequences(seqs: List[Sequence], result: AlignResult,
                   cfg: StitchConfig):
    """Consistency-check depths, sample oriented points per sequence,
    visibility-filter and map everything into the reference frame
    (Processor.cpp:905-1040). Returns (points [P,3], normals [P,3]) numpy."""
    all_pts, all_nrm = [], []
    for k, seq in enumerate(seqs):
        disp = check_consistency(seq.disparity, seq.cams,
                                 min_dsp=cfg.min_dsp, max_dsp=cfg.max_dsp,
                                 reproj_err=cfg.reproj_err)
        op = sample_oriented_points(
            disp, seq.cams, min_dsp=cfg.min_dsp, max_dsp=cfg.max_dsp,
            sample_radius=cfg.sample_radius, nbr_num=cfg.nbr_frm_num,
            nbr_step=cfg.nbr_frm_step, dsp_err=cfg.dsp_err,
            conf_min=cfg.conf_min)
        T = result.transforms[k].to(disp.device)
        pts, nrm, v = _fuse_one(op.points, op.valid, op.normals, seq.cams, T)
        all_pts.append(pts[v])
        all_nrm.append(nrm[v])
    return (torch.cat(all_pts).cpu().numpy(),
            torch.cat(all_nrm).cpu().numpy())
