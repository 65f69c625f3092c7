"""Bundle-adjustment refinement of the sequence chain
(``align_sequences(refine="ba")``, the CLI's ``--refine ba``).

PyTorch counterpart of ``multiviewstitch_tpu/pipeline/ba_refine.py``;
with a mesh the LM solve shards its points (``parallel/ba_dist``). The
reference never refines: every pose is one RANSAC solve
(Processor.cpp:813-826).

  - every keyframe (seq, frame) that carries surviving cross-sequence
    matches becomes a BA camera, initialized from the SRT chain: a point
    X in the reference frame projects into frame f of sequence q (chain
    transform T_q = (s, R_T, t_T), seq world -> reference) through the
    composite rigid camera
        R' = R_f R_T^T,   t' = -R' t_T + s t_f
    (the similarity's scale folds into the projective depth, so the
    composite camera is rigid and solve_ba's 6-dof parameters apply).
  - matches merge into tracks by their source-pixel identity (seq, frame,
    u, v) through a union-find, so a pixel matched in several edges
    becomes one multi-view point.
  - track points start at the mean of their members' depth lifts mapped
    into the reference frame.
  - gauge: the cameras of the reference sequence (identity chain
    transform) stay fixed.
  - before the LM solve, the observations that the chain's cameras
    reproject far from their pixel are left out (``drop_outliers``): a
    wrong match that RANSAC kept, or two tracks that one wrong match
    merged, sits tens to hundreds of pixels off, and left in the least
    squares it stalls the LM (every step rejected until the damping caps)
    or pulls the cameras away from the chain. The JAX package solves on
    every observation.
  - after the LM solve each sequence's similarity is re-fit from its
    refined cameras: R_T = nearest rotation of mean_f R'_f^T R_f, and
    (s, t_T) from the stacked linear system s t_f - R'_f t_T = t'_f. A
    sequence with one observed frame cannot determine s, so the chain
    scale stays and only R_T / t_T update; so too when the least-squares
    scale fails its sanity gates.
The problem is assembled on the host (numpy, as the JAX package does, so
the layout is identical) and solved on the sequences' device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.transforms import Similarity
from ..solvers.ba import (BAState, apply_mask, make_problem,
                          reprojection_rmse, residuals, rodrigues, solve_ba)
from ..solvers.unionfind import UnionFind
from ..utils.profiling import count, span


# an observation the start state reprojects further than OUTLIER_MEDIANS
# times the median residual from its pixel, and further than
# OUTLIER_FLOOR_PX, is an outlier: on the body rings the chain's median
# residual is 1.5-4 px and the wrong matches' tens to hundreds; the floor
# keeps every observation of a sub-pixel chain within a few pixels
OUTLIER_MEDIANS = 3.0
OUTLIER_FLOOR_PX = 4.0


def _rotmat_to_rvec(R: np.ndarray) -> np.ndarray:
    """Host-side SO(3) log map [3,3] -> axis-angle [3] (the inverse of
    solvers.ba.rodrigues) by Shepperd's quaternion extraction, stable at
    every angle."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    # divide by the largest of (trace, R00, R11, R22)
    choices = np.r_[t, np.diag(R)]
    k = int(np.argmax(choices))
    if k == 0:
        r = np.sqrt(max(1.0 + t, 0.0))
        q = 0.5 * np.array([r, (R[2, 1] - R[1, 2]) / r,
                            (R[0, 2] - R[2, 0]) / r,
                            (R[1, 0] - R[0, 1]) / r])
    else:
        i = k - 1
        j, l = (i + 1) % 3, (i + 2) % 3
        r = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[l, l], 1e-24))
        q = np.empty(4)
        q[0] = (R[l, j] - R[j, l]) / (2 * r)
        q[1 + i] = 0.5 * r
        q[1 + j] = (R[j, i] + R[i, j]) / (2 * r)
        q[1 + l] = (R[l, i] + R[i, l]) / (2 * r)
    if q[0] < 0:
        q = -q
    q /= np.linalg.norm(q)
    nv = np.linalg.norm(q[1:])
    if nv < 1e-12:
        return np.zeros(3, np.float32)
    theta = 2.0 * np.arctan2(nv, q[0])
    return (q[1:] / nv * theta).astype(np.float32)


def _nearest_rotation(M: np.ndarray) -> np.ndarray:
    """Nearest SO(3) matrix to M (host, one 3x3): R = U V^T with the det
    sign fix."""
    U, _, Vt = np.linalg.svd(M)
    d = np.sign(np.linalg.det(U @ Vt))
    return (U @ np.diag([1.0, 1.0, d]) @ Vt).astype(np.float32)


def _host_sim(T: Similarity):
    """(s, R, t) of a similarity as float64 host values."""
    return (float(T.s), T.R.cpu().numpy().astype(np.float64),
            T.t.cpu().numpy().astype(np.float64))


def build_ba_problem(seqs, pairs, transforms, *, min_obs: int = 2):
    """Assemble the BA problem from the edge sweep's surviving matches.

    ``pairs``: list of (k, l, PairCandidate) with frame_i in seq k and
    frame_j in seq l (uv1/uv2 [M,2] int source pixels, p1/p2 [M,3] depth
    lifts in each sequence's own world, mask [M]). ``transforms``: the
    chain (per-seq Similarity into the reference frame).

    Returns (prob, st0, cam_map) on the sequences' device, or None when no
    usable matches exist or a participating frame's intrinsics differ from
    the first (BA shares one K); cam_map is {(seq, frame): cam_id}.
    """
    # 1. observations keyed by source-pixel identity
    obs_key: Dict[Tuple[int, int, int, int], int] = {}
    obs_uv: List[Tuple[float, float]] = []
    obs_cam_key: List[Tuple[int, int]] = []
    obs_lift: List[np.ndarray] = []     # lift in the reference frame
    links: List[Tuple[int, int]] = []
    host_T = [_host_sim(T) for T in transforms]

    def obs_id(q, f, uv, p):
        key = (q, f, int(uv[0]), int(uv[1]))
        if key not in obs_key:
            s, R, t = host_T[q]
            obs_key[key] = len(obs_uv)
            obs_uv.append((float(uv[0]), float(uv[1])))
            obs_cam_key.append((q, f))
            obs_lift.append(s * (R @ np.asarray(p, np.float64)) + t)
        return obs_key[key]

    for k, l, c in pairs:
        m = np.asarray(c.mask, bool)
        uv1, uv2 = np.asarray(c.uv1)[m], np.asarray(c.uv2)[m]
        p1, p2 = np.asarray(c.p1)[m], np.asarray(c.p2)[m]
        for a in range(len(uv1)):
            links.append((obs_id(k, c.frame_i, uv1[a], p1[a]),
                          obs_id(l, c.frame_j, uv2[a], p2[a])))
    n_obs = len(obs_uv)
    if n_obs == 0 or not links:
        return None

    # 2. union-find merge into tracks
    uf = UnionFind(n_obs)
    for a, b in links:
        uf.union(a, b)
    root = np.asarray([uf.find(i) for i in range(n_obs)])
    uniq, track_of = np.unique(root, return_inverse=True)
    n_tracks = len(uniq)

    # keep tracks with >= min_obs observations in >= 2 distinct cameras
    cams_sorted = sorted(set(obs_cam_key))
    cam_map = {ck: i for i, ck in enumerate(cams_sorted)}
    n_cams = len(cams_sorted)
    cam_of_obs = np.asarray([cam_map[ck] for ck in obs_cam_key])
    n_obs_of = np.bincount(track_of, minlength=n_tracks)
    pairs_tc = np.unique(track_of.astype(np.int64) * n_cams + cam_of_obs)
    n_cams_of = np.bincount(pairs_tc // n_cams, minlength=n_tracks)
    keep_track = (n_obs_of >= min_obs) & (n_cams_of >= 2)
    new_tid = np.cumsum(keep_track) - 1
    keep_obs = keep_track[track_of]
    if not keep_obs.any():
        return None
    pt_idx = new_tid[track_of[keep_obs]].astype(np.int32)
    cam_idx = cam_of_obs[keep_obs].astype(np.int32)
    uv = np.asarray(obs_uv, np.float32)[keep_obs]
    n_points = int(keep_track.sum())

    # 3. init points: mean of member lifts in the reference frame
    lifts = np.asarray(obs_lift, np.float64)[keep_obs]
    pts0 = np.zeros((n_points, 3))
    cnt = np.zeros(n_points)
    np.add.at(pts0, pt_idx, lifts)
    np.add.at(cnt, pt_idx, 1.0)
    pts0 /= np.maximum(cnt[:, None], 1.0)

    # 4. composite cameras from the chain init. BA shares one K: a
    # participating frame whose K deviates from the first skips BA (the
    # caller keeps the chain, with ba_skipped = 1)
    host_cams = [(s.cams.K.cpu().numpy(), s.cams.R.cpu().numpy(),
                  s.cams.t.cpu().numpy()) for s in seqs]
    K0 = host_cams[0][0][0]
    for (q, f) in cam_map:
        if not np.allclose(host_cams[q][0][f], K0, rtol=1e-4,
                           atol=1e-3 * abs(K0[0, 0])):
            return None
    rvec0 = np.zeros((n_cams, 3), np.float32)
    tvec0 = np.zeros((n_cams, 3), np.float32)
    fixed = np.zeros(n_cams, bool)
    ref_seq = _reference_sequence(transforms)
    for (q, f), cid in cam_map.items():
        s, R_T, t_T = host_T[q]
        R_f = host_cams[q][1][f].astype(np.float64)
        t_f = host_cams[q][2][f].astype(np.float64)
        Rp = R_f @ R_T.T
        tp = -Rp @ t_T + s * t_f
        rvec0[cid] = _rotmat_to_rvec(Rp.astype(np.float32))
        tvec0[cid] = tp.astype(np.float32)
        fixed[cid] = q == ref_seq
    if not fixed.any():                      # the gauge must be pinned
        fixed[0] = True

    count("ba.cameras", n_cams)
    count("ba.points", n_points)
    count("ba.observations", len(pt_idx))
    dev = seqs[0].cams.K.device
    prob = make_problem(K0, cam_idx, pt_idx, uv, n_points,
                        fixed_cams=np.flatnonzero(fixed), n_cams=n_cams,
                        device=dev)
    st0 = BAState(torch.as_tensor(rvec0, device=dev),
                  torch.as_tensor(tvec0, device=dev),
                  torch.as_tensor(pts0.astype(np.float32), device=dev))
    return prob, st0, cam_map


def _reference_sequence(transforms) -> int:
    """The sequence whose chain transform is the identity (the last one,
    Processor.cpp:819-823): its cameras pin the gauge."""
    best, berr = len(transforms) - 1, np.inf
    for q, T in enumerate(transforms):
        s, R, t = _host_sim(T)
        err = abs(s - 1.0) + float(np.abs(R - np.eye(3)).sum()) + \
            float(np.abs(t).sum())
        if err < berr:
            best, berr = q, err
    return best


def drop_outliers(prob, st: BAState):
    """``prob`` without the observations ``st`` reprojects further than
    max(OUTLIER_MEDIANS x the median residual, OUTLIER_FLOOR_PX) pixels
    from their pixel (``solvers/ba.apply_mask``), with no host read.
    Returns (problem, [O] bool mask of the observations left out)."""
    r = torch.linalg.norm(residuals(prob, st), dim=-1)
    med = torch.where(prob.mask, r, torch.full_like(r, float("nan")))
    limit = (OUTLIER_MEDIANS * med.nanmedian()).clamp_min(OUTLIER_FLOOR_PX)
    out = prob.mask & (r > limit)
    return apply_mask(prob, ~out), out


def refit_similarities(seqs, transforms, st: BAState, cam_map
                       ) -> List[Similarity]:
    """Per-sequence similarity re-fit from the refined composite cameras
    (see the module docstring for the algebra). Returns CPU similarities."""
    ref_seq = _reference_sequence(transforms)
    rvec = st.rvec.cpu()
    tvec = st.tvec.cpu().numpy().astype(np.float64)
    out: List[Similarity] = []
    for q, T in enumerate(transforms):
        frames = [f for (qq, f) in cam_map if qq == q]
        if q == ref_seq or not frames:
            out.append(T)
            continue
        s_chain = float(T.s)
        R_all = seqs[q].cams.R.cpu().numpy().astype(np.float64)
        t_all = seqs[q].cams.t.cpu().numpy().astype(np.float64)
        Rsum = np.zeros((3, 3))
        Rps, tps, Rfs, tfs = [], [], [], []
        for f in frames:
            cid = cam_map[(q, f)]
            Rp = rodrigues(rvec[cid]).numpy().astype(np.float64)
            Rsum += Rp.T @ R_all[f]
            Rps.append(Rp)
            tps.append(tvec[cid])
            Rfs.append(R_all[f])
            tfs.append(t_all[f])
        R_T = _nearest_rotation(Rsum / len(frames)).astype(np.float64)

        # stacked LS for (s, t_T):  s t_f - R'_f t_T = t'_f
        if len(frames) >= 2:
            A = np.concatenate(
                [np.concatenate([t[:, None], -Rp], 1)
                 for t, Rp in zip(tfs, Rps)], 0)          # [3F, 4]
            b = np.concatenate(tps)
            x, _, rank, _ = np.linalg.lstsq(A, b, rcond=None)
            s_new = float(x[0])
            t_T = x[1:]
            bad = (rank < 4 or s_new <= 0 or
                   abs(np.log(max(s_new, 1e-12) / s_chain)) > 0.7)
        else:
            bad = True
        if bad:
            # keep the chain's (RANSAC 3D-3D) scale; solve t_T from each
            # frame and average:  t_T = R'^T (s t_f - t')
            s_new = s_chain
            t_T = np.mean([Rp.T @ (s_new * t - tp)
                           for Rp, t, tp in zip(Rps, tfs, tps)], 0)
        out.append(Similarity(torch.tensor(s_new, dtype=torch.float32),
                              torch.as_tensor(R_T, dtype=torch.float32),
                              torch.as_tensor(t_T, dtype=torch.float32)))
    return out


def _solve_sharded(prob, st0: BAState, mesh, iters: int):
    """solve_ba_sharded on the grouped layout of ``prob``, its points
    padded to a multiple of the mesh size with zero-observation dummies
    (all-false masks: they add nothing, and their updates are dropped)."""
    from ..parallel.ba_dist import BAPointBlocks, solve_ba_sharded
    n_pts = st0.points.shape[0]
    n_pad = (-n_pts) % mesh.size

    def pad(x):
        return torch.cat([x, x.new_zeros((n_pad,) + x.shape[1:])])
    blocks = BAPointBlocks(prob.K, pad(prob.cam_of), pad(prob.uv_g),
                           pad(prob.pt_obs_mask), prob.fixed_cams)
    st, rmse = solve_ba_sharded(blocks, st0._replace(points=pad(st0.points)),
                                mesh, iters=iters)
    return st._replace(points=st.points[:n_pts]), rmse


def refine_with_ba(seqs, pairs, transforms, *, iters: int = 30,
                   mesh=None, verbose: bool = False
                   ) -> Tuple[List[Similarity], Dict[str, float]]:
    """Bundle adjustment of the chain on its surviving matches, less the
    outliers (``drop_outliers``), then the per-sequence similarity re-fit.
    Returns (new transforms, metrics: ba_rmse_init_px, ba_rmse_px, ba_cams,
    ba_tracks, ba_obs, the RMSEs and the count over the observations
    kept); with no usable tracks, the input chain and {"ba_skipped": 1.0}.
    With ``mesh`` the LM solve shards point blocks over its ranks. Spans
    ``ba.build``, ``ba.solve`` and ``ba.refit``; the build counts
    ``ba.cameras``, ``ba.points`` and ``ba.observations``, the solve
    ``ba.outliers`` and, on one device, ``ba.lm_iterations`` and
    ``ba.lm_accepted``."""
    with span("ba.build"):
        built = build_ba_problem(seqs, pairs, transforms)
    if built is None:
        return list(transforms), {"ba_skipped": 1.0}
    prob, st0, cam_map = built
    with span("ba.solve"):
        prob, out = drop_outliers(prob, st0)
        rmse0, n_out = torch.stack([reprojection_rmse(prob, st0),
                                    out.sum().to(torch.float32)]).tolist()
        count("ba.outliers", int(n_out))
        if mesh is None:
            st, rmse = solve_ba(prob, st0, iters=iters, verbose=verbose)
        else:
            st, rmse = _solve_sharded(prob, st0, mesh, iters)
    with span("ba.refit"):
        refined = refit_similarities(seqs, transforms, st, cam_map)
    metrics = {"ba_rmse_init_px": rmse0, "ba_rmse_px": rmse,
               "ba_cams": float(st.rvec.shape[0]),
               "ba_tracks": float(st.points.shape[0]),
               "ba_obs": float(prob.mask.sum())}
    return refined, metrics
