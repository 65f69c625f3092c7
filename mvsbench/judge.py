"""The comparison that decides ``correct``: the numbers a job's outputs
give against the reference, each held to a limit of the cell's
(``workloads/<cell>.json``; a number without a limit there is reported
and not compared).

Numbers of every job:
  srt_surface_gap  the worst over sequences of the RMS distance between the
                   true surface mapped by the job's SRT.txt similarity and
                   by the true one (the similarity's error where it
                   matters, in scene units)
  srt_rot_deg, srt_scale_err, srt_t_err   the same error by its parts
  cloud_gap        99th percentile over PSR.npts of the distance to the
                   nearest point of the reference's fused cloud
  cloud_count_gap  |points - reference points| / reference points
  normal_gap       99th percentile of 1 - cos between a point's normal and
                   its nearest reference point's
  cloud_to_surface RMS over the reference's fused cloud of the distance to
                   the nearest vertex of Model.obj: the reconstruction and
                   its trim cover the data they were built from
  surface_rmse     RMS distance from the final surface's vertices to the
                   true surface (the final surface: the config's
                   ``final_surface``)
  extra_components Model.obj's connected components beyond one: the trim
                   keeps the largest (an exact comparison, limit 0)
and of a job that fits the template (``deform.obj``):
  fit_rms          RMS distance from deform.obj's vertices to Model.obj
and of one that re-renders it (``render``):
  render_mismatch  pixels covered by one of the job's rasters and the
                   reference's but not both, over those the reference covers
  render_gap       99.9th percentile over pixels both cover of the relative
                   disparity difference
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np

from . import reference as ref
from .geometry import Mat, rotation_angle_deg

# the fuse's settings, by their keys in the reference's config.txt; every
# configuration states each of them, so the program and the reference read
# the same values
FUSE_KEYS = {"MinDsp": "min_dsp", "MaxDsp": "max_dsp",
             "ReprojError": "reproj_err", "PtSampRds": "sample_radius",
             "NbrFrmNum": "nbr_frm_num", "NbrFrmStep": "nbr_frm_step",
             "MaxDspErr": "dsp_err", "MinConf": "conf_min"}


def srt_errors(srt, gt) -> Dict[str, float]:
    """The worst scale, rotation and translation error over sequences."""
    if len(srt) != len(gt):
        return dict(srt_rot_deg=math.inf, srt_scale_err=math.inf,
                    srt_t_err=math.inf)
    return dict(
        srt_rot_deg=max(rotation_angle_deg(T.R, g.R) for T, g in
                        zip(srt, gt)),
        srt_scale_err=max(abs(T.s - g.s) / g.s for T, g in zip(srt, gt)),
        srt_t_err=max(float(np.linalg.norm(T.t - g.t)) for T, g in
                      zip(srt, gt)))


def srt_surface_gap(srt, gt, truth: np.ndarray) -> float:
    """The worst over sequences k of the RMS of |T_k(v) - truth| over the
    true surface's vertices v in sequence k's frame."""
    if len(srt) != len(gt):
        return math.inf
    truth = truth.astype(np.float64)
    return max(rms(np.linalg.norm(T.apply(g.inverse().apply(truth)) - truth,
                                  axis=1)) for T, g in zip(srt, gt))


def cloud_numbers(pts, nrm, ref_pts, ref_nrm) -> Dict[str, float]:
    if len(pts) == 0 or len(ref_pts) == 0:
        return dict(cloud_gap=math.inf, cloud_count_gap=math.inf,
                    normal_gap=math.inf)
    d, i = ref.nearest(pts, ref_pts)
    cos = (nrm.astype(np.float64) * ref_nrm[i].astype(np.float64)).sum(1)
    return dict(cloud_gap=float(np.percentile(d, 99)),
                cloud_count_gap=abs(len(pts) - len(ref_pts)) / len(ref_pts),
                normal_gap=float(np.percentile(1.0 - cos, 99)))


def render_numbers(job_rasters: List[np.ndarray],
                   ref_rasters: List[np.ndarray]) -> Dict[str, float]:
    a = np.concatenate([r.reshape(-1) for r in job_rasters])
    b = np.concatenate([r.reshape(-1) for r in ref_rasters])
    both = (a > 0) & (b > 0)
    covered = max(int((b > 0).sum()), 1)
    rel = np.abs(a[both] - b[both]) / b[both]
    return dict(render_mismatch=int(((a > 0) != (b > 0)).sum()) / covered,
                render_gap=float(np.percentile(rel, 99.9)) if rel.size
                else math.inf)


def rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x)))) if len(x) else math.inf


class Judge:
    """Judges the jobs of one run against one scene. The reference's fused
    cloud is computed once per distinct SRT.txt."""

    def __init__(self, scene, config: dict, device, precision="float32"):
        self.scene = scene
        self.config = config
        self.device = device
        self.mat = Mat(precision)
        self.fuse_cfg = {f: config["settings"][k]
                         for k, f in FUSE_KEYS.items()}
        self._fused = {}

    def reference_cloud(self, srt):
        key = tuple(tuple(np.concatenate([[T.s], T.R.ravel(), T.t]))
                    for T in srt)
        if key not in self._fused:
            seqs = [(f.disparity.to(self.device), f.cams.to(self.device))
                    for f in self.scene.sequences]
            self._fused[key] = ref.fuse(seqs, srt, self.fuse_cfg, self.mat)
        return self._fused[key]

    def job(self, workdir: str, render_dirs=None) -> Dict[str, float]:
        """The numbers of the job whose results are under ``workdir``;
        ``render_dirs``: the sequence directories holding its rasters."""
        res = os.path.join(workdir, "Result")
        srt = ref.read_srt(os.path.join(res, "SRT.txt"))
        out = srt_errors(srt, self.scene.gt)
        out["srt_surface_gap"] = srt_surface_gap(
            srt, self.scene.gt, self.scene.truth_vertices)
        pts, nrm = ref.read_npts(os.path.join(res, "PSR.npts"))
        mv, mf = ref.read_obj(os.path.join(res, "Model.obj"))
        if len(srt) == len(self.scene.gt):
            rp, rn = self.reference_cloud(srt)
            out.update(cloud_numbers(pts, nrm, rp, rn))
            out["cloud_to_surface"] = rms(ref.nearest(rp, mv)[0])
        else:
            out.update(cloud_numbers(pts, nrm, np.zeros((0, 3)), None))
            out["cloud_to_surface"] = math.inf
        out["extra_components"] = float(ref.components(len(mv), mf) - 1)
        truth = (self.scene.truth_vertices, self.scene.truth_faces)
        final = self.config["final_surface"]
        if final == "Model.obj":
            fv = mv
        else:
            fv, ff = ref.read_obj(os.path.join(res, final))
            out["fit_rms"] = rms(ref.surface_distance(fv, mv, mf,
                                                      self.device))
        out["surface_rmse"] = rms(ref.surface_distance(fv, *truth,
                                                       self.device))
        if render_dirs is not None:
            cams = [f.cams.to(self.device) for f in self.scene.sequences]
            mine = [np.stack([ref.read_raw(
                os.path.join(d, "DATA", "Render", f"_depth{i}.raw"),
                c.width, c.height) for i in range(len(c))])
                for d, c in zip(render_dirs, cams)]
            theirs = [r.cpu().numpy() for r in
                      ref.render(fv, ff, srt, cams, self.mat)]
            out.update(render_numbers(mine, theirs))
        return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every limited number at or under its limit (a
    limit whose number is missing fails); no limits at all fails."""
    checks = {}
    ok = bool(limits)
    for name in sorted(limits):
        v = numbers.get(name, math.inf)
        ok &= v <= limits[name]
        checks[name] = {"value": v, "limit": limits[name]}
    return ok, checks


def worst(per_job: List[Dict[str, float]]) -> Dict[str, float]:
    out = {}
    for nums in per_job:
        for k, v in nums.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out
