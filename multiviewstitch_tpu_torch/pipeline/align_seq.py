"""Sequence alignment pipeline: AlignmentSeq in PyTorch.

PyTorch counterpart of ``multiviewstitch_tpu/pipeline/align_seq.py``
(Processor::AlignmentSeq + CalcSimilarityTransformationSeq,
Processor.cpp:835-1106): per-sequence prep -> per-pair edge sweep ->
keyframe selection + SRT solve -> greedy left-compose chain -> optional
view-graph refinement (pose graph or bundle adjustment, over the
surviving matches of every eligible frame pair, optionally with skip
edges); then consistency check (K1) -> oriented point sampler (K2) ->
visibility filter -> transform into the reference frame.

With a ``mesh`` (``parallel.make_mesh``), every rank runs the prep
(replicated), the edge sweep is sharded over the ranks
(``parallel/match_dist``) and bundle adjustment shards its points
(``parallel/ba_dist``); every rank returns the same result.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import StitchConfig
from ..core.cameras import CameraBatch
from ..core.transforms import Similarity
from ..ops.consistency import check_consistency
from ..ops.point_sampling import sample_oriented_points, visibility_filter
from ..solvers.srt import stream_key


@dataclass
class Sequence:
    """One RGB-D sequence: gray [N,H,W] (0..255), disparity [N,H,W],
    cameras (batch N)."""
    gray: torch.Tensor
    disparity: torch.Tensor
    cams: CameraBatch


@dataclass
class PairCandidate:
    """One frame pair's surviving matches, on the host (numpy)."""
    frame_i: int
    frame_j: int
    uv1: np.ndarray          # [M,2] source-pixel coords (int)
    uv2: np.ndarray
    p1: np.ndarray           # [M,3] 3D points lifted from frame i
    p2: np.ndarray
    mask: np.ndarray         # [M] bool after the full filter cascade
    residual: float
    num_matches: int


@dataclass
class AlignResult:
    transforms: List[Similarity]      # per sequence -> final frame (CPU)
    keyframes: List[Tuple[int, int]]  # chosen (frame_i, frame_j) per pair
    residuals: List[float]
    metrics: Dict[str, float] = field(default_factory=dict)


def _candidates(eb, sel, n2: int, res, nm) -> List[PairCandidate]:
    """The edges ``sel`` of an EdgeBatch as PairCandidates, pulled to the
    host in one transfer (uv, points and mask packed into one float64
    tensor: the int pixel ids and float32 points are exact in it)."""
    if len(sel) == 0:
        return []
    idx = torch.as_tensor(sel, device=eb.p1.device)
    packed = torch.cat([eb.uv1[idx].double(), eb.uv2[idx].double(),
                        eb.p1[idx].double(), eb.p2[idx].double(),
                        eb.mask[idx][..., None].double()], -1).cpu().numpy()
    out = []
    for k, e in enumerate(sel):
        a = packed[k]
        out.append(PairCandidate(
            int(e) // n2, int(e) % n2, a[:, 0:2].astype(np.int32),
            a[:, 2:4].astype(np.int32), a[:, 4:7].astype(np.float32),
            a[:, 7:10].astype(np.float32), a[:, 10] > 0, float(res[e]),
            int(nm[e])))
    return out


def match_sequence_pair(seq1: Sequence, seq2: Sequence, cfg: StitchConfig,
                        key: int, prep1=None, prep2=None, mesh=None,
                        want_candidates: bool = True
                        ) -> Tuple[Similarity, PairCandidate,
                                   List[PairCandidate]]:
    """Best keyframe pair between two sequences and its SRT (the per-pair
    body of CalcSimilarityTransformationSeq, Processor.cpp:629-833);
    RANSAC draws from ``key``'s stream (``solvers.srt.stream_key``), and
    with ``mesh`` the edge sweep is sharded over its ranks.
    Returns (T, best, candidates): with ``want_candidates``, every edge
    with >= 3 surviving matches as a host-side PairCandidate (the input of
    refinement and the debug dumps); without, best carries only its
    frame ids and statistics."""
    from .match_edges import (prep_sequence, match_edges, edge_knobs,
                              select_and_solve)
    n2 = seq2.gray.shape[0]
    if prep1 is None:
        prep1 = prep_sequence(seq1, cfg)
    if prep2 is None:
        prep2 = prep_sequence(seq2, cfg)
    if mesh is None:
        eb = match_edges(prep1, prep2, key, **edge_knobs(cfg))
    else:
        from ..parallel.match_dist import match_edges_sharded
        eb = match_edges_sharded(prep1, prep2, key, mesh=mesh,
                                 **edge_knobs(cfg))
    ok_any, best_e, nm, res, T = select_and_solve(
        eb, seq1.cams, seq2.cams, key,
        min_match_count=cfg.min_match_count, iter_num=cfg.iter_num)
    if not ok_any:
        raise RuntimeError(
            f"no frame pair with >= {cfg.min_match_count} matches "
            f"(best had {int(nm.max())}) — cannot align sequences "
            "(Processor.cpp:794-800 analogue)")
    candidates: List[PairCandidate] = []
    best = None
    if want_candidates:
        sel = torch.nonzero(nm >= 3)[:, 0].tolist()
        candidates = _candidates(eb, sel, n2, res, nm)
        best = next((c for c, e in zip(candidates, sel) if e == best_e),
                    None)
    if best is None:
        empty = np.zeros((0,), np.float32)
        best = PairCandidate(best_e // n2, best_e % n2, empty, empty, empty,
                             empty, empty.astype(bool), float(res[best_e]),
                             int(nm[best_e]))
    return T, best, candidates


def _compose_host(A: Similarity, B: Similarity) -> Similarity:
    """compose() on float32 CPU tensors: s = sA*sB, R = RA@RB,
    t = sA*RA@tB + tA (Processor.cpp:819-823)."""
    return Similarity(A.s * B.s, A.R @ B.R, A.s * (A.R @ B.t) + A.t)


def _dump_matches(debug_dir, k, seqs, best: PairCandidate):
    """The reference's Match/match<k>_<i>_<j> dump of the chosen pair
    (Processor.cpp:767-793)."""
    from ..utils.debug_artifacts import save_match_visualization
    os.makedirs(debug_dir, exist_ok=True)
    save_match_visualization(
        os.path.join(debug_dir,
                     f"match{k}_{best.frame_i}_{best.frame_j}.png"),
        seqs[k].gray[best.frame_i].cpu().numpy(),
        seqs[k + 1].gray[best.frame_j].cpu().numpy(),
        best.uv1, best.uv2, best.mask)


def refine_alignment(seqs: List[Sequence], cfg: StitchConfig,
                     result: AlignResult, candidates, refine, seed: int,
                     preps, all_pairs: bool = False,
                     mesh=None) -> AlignResult:
    """View-graph refinement of the greedy chain in ``result`` (the
    reference has none; SURVEY §7 step 6), from ``candidates``: per
    consecutive pair k, the list match_sequence_pair returned.
      - True or "pose_graph": global similarity pose graph over every
        candidate with >= min_match_count matches (solvers/pose_graph)
      - "ba": reprojection bundle adjustment over keyframe cameras and
        union-find-merged pixel tracks (pipeline/ba_refine)
    ``all_pairs`` adds the skip edges (k, l > k+1), matched here from the
    stream of pair (k, l). ``mesh`` shards their sweeps and BA's points."""
    mode = "pose_graph" if refine is True else str(refine)
    cand_pairs = [(k, k + 1, c) for k, cands in enumerate(candidates)
                  for c in cands if c.num_matches >= cfg.min_match_count]
    if all_pairs:
        # the reference only ever links consecutive sequences
        # (Processor.cpp:629); skip edges over-determine the graph
        for k in range(len(seqs) - 2):
            for l in range(k + 2, len(seqs)):
                try:
                    _, _, cands = match_sequence_pair(
                        seqs[k], seqs[l], cfg, pair_key(seed, k, l, len(seqs)),
                        preps[k], preps[l], mesh=mesh)
                except RuntimeError:
                    continue
                cand_pairs += [(k, l, c) for c in cands
                               if c.num_matches >= cfg.min_match_count]
    if not cand_pairs:
        return result
    if mode == "ba":
        from .ba_refine import refine_with_ba
        refined, metrics = refine_with_ba(seqs, cand_pairs,
                                          result.transforms, mesh=mesh)
    else:
        from ..solvers.pose_graph import build_data, refine_pose_graph
        pairs = [(k, l, c.p1, c.p2, c.mask) for k, l, c in cand_pairs]
        data = build_data(pairs, max_matches=cfg.max_matches,
                          device=seqs[0].gray.device)
        refined, rmse = refine_pose_graph(result.transforms, data)
        metrics = {"pose_graph_rmse": rmse,
                   "pose_graph_edges": float(len(pairs))}
    return AlignResult(refined, result.keyframes, result.residuals, metrics)


def pair_key(seed: int, k: int, l: int, n_seqs: int) -> int:
    """The RANSAC stream key of the sweep between sequences k and l."""
    return stream_key(seed, k * n_seqs + l)


def align_sequences(seqs: List[Sequence], cfg: StitchConfig,
                    seed: int = 0, preps=None, refine=False,
                    all_pairs: bool = False, debug_dir: str = None,
                    stage=None, mesh=None) -> AlignResult:
    """Chain all sequences into the last sequence's frame (greedy chain,
    the reference's behaviour, Processor.cpp:813-826), then refine it with
    ``refine`` (False, True / "pose_graph" or "ba"; see
    ``refine_alignment``). RANSAC draws from the counter stream of
    (``seed``, sequence pair, edge). ``preps``: the sequences'
    ``prep_sequence`` results, if already computed. ``debug_dir`` (or
    cfg.debug_artifacts, into ./Match): the chosen pairs' match dumps
    (rank 0's, with a mesh). ``mesh`` shards the edge sweeps and BA over
    its ranks. The sweep and the refinement run as
    ``stage("sweep_solve_s", fn)`` and ``stage("refine_s", fn)`` when a
    ``stage`` hook is given."""
    from .match_edges import prep_sequence
    run = stage or (lambda name, fn: fn())
    if preps is None:
        preps = [prep_sequence(s, cfg) for s in seqs]
    dump = debug_dir or ("./Match" if cfg.debug_artifacts else None)
    want = bool(refine) or dump is not None
    if mesh is not None and mesh.rank != 0:
        dump = None

    def sweep():
        edges, keyframes, residuals, candidates = [], [], [], []
        for k in range(len(seqs) - 1):
            T, best, cands = match_sequence_pair(
                seqs[k], seqs[k + 1], cfg, pair_key(seed, k, k + 1, len(seqs)),
                preps[k], preps[k + 1], mesh=mesh, want_candidates=want)
            edges.append(T)
            keyframes.append((best.frame_i, best.frame_j))
            residuals.append(best.residual)
            candidates.append(cands)
            if dump is not None:
                _dump_matches(dump, k, seqs, best)
        transforms = []
        for k in range(len(seqs)):
            acc = Similarity.identity(device="cpu")
            for j in range(k, len(edges)):
                acc = _compose_host(edges[j], acc)
            transforms.append(acc)
        return AlignResult(transforms, keyframes, residuals), candidates

    result, candidates = run("sweep_solve_s", sweep)
    if refine and len(seqs) > 1:
        result = run("refine_s", lambda: refine_alignment(
            seqs, cfg, result, candidates, refine, seed, preps, all_pairs,
            mesh))
    return result


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
