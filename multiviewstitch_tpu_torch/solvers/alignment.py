"""Template-body rigid alignment: ground removal, PCA init, per-limb local
alignment.

PyTorch counterpart of ``multiviewstitch_tpu/solvers/alignment.py``
(Alignment/Alignment.{h,cpp}):
  - remove_ground:      Alignment.cpp:79-233
  - init_alignment:     Alignment.cpp:235-314
  - local_alignment:    Alignment.cpp:316-421 (+ core 423-546)
  - align (entry):      Alignment.cpp:11-77
The numeric cores (PCA, plane fit, extents, rotations, the part-label 1-NN)
run on ``device`` (solvers/pca.py, models/parts.py), their sums in
float64; the compactions and per-limb loops stay on the host, as in the
JAX package: the point counts are thousands. Inputs and outputs are numpy
arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.transforms import rotation_between
from ..models import parts as P
from ..models.parts import part_recog
from ..utils.profiling import span
from .deformation import TIE_REL
from .pca import extent_along, pivots, plane_fit
from .unionfind import retain_largest_component


# the template's stored frame (models/template_body: Y up, facing +Z):
# the direction of its ground and the one it faces
TEMPLATE_GROUND_RAY = np.array([0.0, -1.0, 0.0])
TEMPLATE_VIEW_RAY = np.array([0.0, 0.0, 1.0])


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def _extreme(t, keep, tie, largest):
    """Index of the smallest (or largest) kept projection; projections
    within ``tie`` of it count as tied and the lowest index wins, so float
    noise on a symmetric limb (mirror-pair vertices at one end) does not
    move the choice. The reference takes the first exact extreme."""
    if largest:
        t = -t
    t = np.where(keep, t, np.inf)
    return int(np.argmax(t <= t.min() + tie))


@dataclass
class GroundRemovalResult:
    points: np.ndarray
    normals: Optional[np.ndarray]
    faces: np.ndarray
    ground_ray: np.ndarray       # outward ground direction (unit-ish pivot)


def remove_ground(points: np.ndarray, normals: Optional[np.ndarray],
                  faces: np.ndarray, dist_thres: float = 0.7,
                  plane_band: float = 0.28, *, device) -> GroundRemovalResult:
    """Detect + cut the ground plane (RemoveGround, Alignment.cpp:79-233):

    1. principal axis of the scan; split points by signed projection
    2. candidate far-end sets beyond dist_thres * max extent on each side;
       the LARGER candidate set is the ground side (a body scan has more
       floor points than head points)
    3. LS plane fit to the candidates (A x = -b normal equations)
    4. drop all candidate points within plane_band * maxDist of the plane
    5. keep the largest connected component.
    Returns the ground ray (pointing from body toward ground)."""
    pts = np.asarray(points, np.float32)
    piv, _, center = pivots(_f32(pts, device))
    pivot = _host(piv[:, 0])

    t = (pts - _host(center)) @ pivot / max(float(pivot @ pivot), 1e-12)
    neg = t < 0
    tmax1 = max(float((-t[neg]).max()) if neg.any() else 0.0, 1e-12)
    tmax2 = max(float(t[~neg].max()) if (~neg).any() else 0.0, 1e-12)
    cand1 = np.nonzero(neg & (-t > tmax1 * dist_thres))[0]
    cand2 = np.nonzero(~neg & (t > tmax2 * dist_thres))[0]
    if len(cand1) > len(cand2):
        cand, ground_ray = cand1, -pivot
    else:
        cand, ground_ray = cand2, pivot

    n, d = plane_fit(_f32(points[cand], device))
    n = _host(n)
    d = float(d)
    if n @ pivot < 0:
        n, d = -n, -d

    dist = np.abs(points[cand] @ n + d)
    thr = dist.max() * plane_band
    remove_idx = cand[dist < thr]
    keep = np.ones(len(points), bool)
    keep[remove_idx] = False

    remap = np.cumsum(keep) - 1
    new_pts = points[keep]
    new_nrm = normals[keep] if normals is not None else None
    fmask = keep[faces].all(axis=1)
    new_faces = remap[faces[fmask]].astype(np.int32)

    v2, f2, n2 = retain_largest_component(new_pts, new_faces, new_nrm)
    return GroundRemovalResult(v2, n2, f2, ground_ray)


def init_alignment(src: np.ndarray, tgt: np.ndarray, ground_ray: np.ndarray,
                   view_ray: np.ndarray, *, device
                   ) -> Tuple[float, np.ndarray, np.ndarray]:
    """PCA-frame rigid init (InitAlignment, Alignment.cpp:235-314):
    sign-fix the target's principal frame with the ground ray (axis 0) and
    camera view ray (axis 2) and the template's with its stored ground and
    facing directions, scale = principal-extent ratio,
    R = tgt_pivots @ src_pivots^-1, and translate so the ground-end extents
    meet. Returns (scale, R, t) with x -> scale*R@x + t."""
    src_t, tgt_t = _f32(src, device), _f32(tgt, device)
    sp, _, c1 = pivots(src_t)
    tp, _, c2 = pivots(tgt_t)
    sp = _host(sp).astype(np.float64)
    tp = _host(tp).astype(np.float64)
    c1 = _host(c1).astype(np.float64)
    c2 = _host(c2).astype(np.float64)
    if ground_ray @ tp[:, 0] < 0:
        tp[:, 0] = -tp[:, 0]
    if view_ray @ tp[:, 2] < 0:
        tp[:, 2] = -tp[:, 2]
    # the template is stored ground-aligned (Y up, facing +Z): its axes 0
    # and 2 take the same ground / view orientation as the target's. The
    # reference and the JAX package leave them to eigh, whose signs on the
    # mirror-symmetric template follow float32 summation noise (a flip
    # turns the template upside down); this is the orientation the JAX
    # package's CPU eigh gives the template
    if TEMPLATE_GROUND_RAY @ sp[:, 0] < 0:
        sp[:, 0] = -sp[:, 0]
    if TEMPLATE_VIEW_RAY @ sp[:, 2] < 0:
        sp[:, 2] = -sp[:, 2]
    # consistent handedness so R is a proper rotation: the middle axis is
    # flipped to keep det > 0
    if np.linalg.det(tp) < 0:
        tp[:, 1] = -tp[:, 1]
    if np.linalg.det(sp) < 0:
        sp[:, 1] = -sp[:, 1]

    lo1, hi1, _ = extent_along(src_t, _f32(sp[:, 0], device),
                               _f32(c1, device))
    lo2, hi2, _ = extent_along(tgt_t, _f32(tp[:, 0], device),
                               _f32(c2, device))
    lo1, hi1, lo2, hi2 = map(float, (lo1, hi1, lo2, hi2))
    scale = (hi2 - lo2) / max(hi1 - lo1, 1e-12)

    R = tp @ np.linalg.inv(sp)
    t = (tp[:, 0] * (hi2 - hi1 * scale) + c2 - scale * (R @ c1))
    return scale, R, t


_LIMB_GROUPS = [
    # (member labels for selection, member labels for apply, far label)
    ((P.LEFT_UPPER_ARM, P.LEFT_LOWER_ARM, P.LEFT_HAND),
     (P.LEFT_UPPER_ARM, P.LEFT_LOWER_ARM, P.LEFT_HAND), P.LEFT_HAND),
    ((P.RIGHT_UPPER_ARM, P.RIGHT_LOWER_ARM, P.RIGHT_HAND),
     (P.RIGHT_UPPER_ARM, P.RIGHT_LOWER_ARM, P.RIGHT_HAND), P.RIGHT_HAND),
    ((P.LEFT_THIGH, P.LEFT_SHANK),
     (P.LEFT_THIGH, P.LEFT_SHANK, P.LEFT_FOOT), P.LEFT_SHANK),
    ((P.RIGHT_THIGH, P.RIGHT_SHANK),
     (P.RIGHT_THIGH, P.RIGHT_SHANK, P.RIGHT_FOOT), P.RIGHT_SHANK),
]


def _local_alignment_core(src_pts, s_lbl, tgt_pts, t_lbl, far_label, *,
                          device):
    """Per-limb similarity (LocalAlignmentCore, Alignment.cpp:423-546):
    PCA axes of both limb point sets (sign-matched), extent-ratio scale with
    the far end identified by the far_label (hand/shank), rotation between
    principal axes, anchored at the limb's near end."""
    sp, _, c1 = pivots(_f32(src_pts, device))
    tp, _, c2 = pivots(_f32(tgt_pts, device))
    a1 = _host(sp[:, 0]).astype(np.float64)
    a2 = _host(tp[:, 0]).astype(np.float64)
    c1 = _host(c1).astype(np.float64)
    c2 = _host(c2).astype(np.float64)
    # the template limb's axis points from its far part toward its root,
    # and the target's follows it. The reference leaves the sign to the
    # eigen solver, which matters where the far label is missing from the
    # common labels: then the swaps below always fire, and this sign puts
    # the anchor at the root end
    far = s_lbl == far_label
    if far.any() and (src_pts[far].mean(0) - c1) @ a1 > 0:
        a1 = -a1
    if a1 @ a2 < 0:
        a2 = -a2

    # label harmonization (Alignment.cpp:474-497): use only labels common to
    # both sets when one side is missing a segment
    common = set(s_lbl.tolist()) & set(t_lbl.tolist())
    s_keep = np.isin(s_lbl, list(common))
    t_keep = np.isin(t_lbl, list(common))

    # the tie bound of deformation.stable_knn, on the limb's coordinates
    tie = TIE_REL * float(np.abs(src_pts).max(initial=0.0))
    t1 = (src_pts - c1) @ a1 / max(a1 @ a1, 1e-12)
    f1, n1 = (_extreme(t1, s_keep, tie, big) for big in (False, True))
    lo1, hi1 = t1[f1], t1[n1]
    if s_lbl[n1] != far_label:        # far end must carry the far label
        lo1, hi1 = hi1, lo1
        f1, n1 = n1, f1

    t2 = (tgt_pts - c2) @ a2 / max(a2 @ a2, 1e-12)
    tie2 = TIE_REL * float(np.abs(tgt_pts).max(initial=0.0))
    f2, n2 = (_extreme(t2, t_keep, tie2, big) for big in (False, True))
    lo2, hi2 = t2[f2], t2[n2]
    if t_lbl[n2] != far_label:
        lo2, hi2 = hi2, lo2
        f2, n2 = n2, f2

    # signed ratio exactly like the reference (Alignment.cpp:530): after the
    # far-label swaps both ranges are oriented root->far, so the ratio is
    # normally positive; only guard true degeneracy
    den = hi1 - lo1
    scale = (hi2 - lo2) / den if abs(den) > 1e-9 else 1.0
    R = _host(rotation_between(torch.as_tensor(a1, device=device),
                               torch.as_tensor(a2, device=device)))
    anchor = src_pts[f1]              # anchored at the limb's root end
    t = anchor - scale * (R @ anchor)
    return scale, R, t


def local_alignment(src: np.ndarray, s_normals: Optional[np.ndarray],
                    s_labels: np.ndarray, tgt: np.ndarray,
                    t_labels: np.ndarray, *, device):
    """Refit each limb (arms, legs) with its own similarity
    (LocalAlignment, Alignment.cpp:316-421). Returns (src', normals')
    without mutating the inputs."""
    out = src.copy()
    nrm_out = None if s_normals is None else np.array(s_normals)
    for sel_labels, apply_labels, far in _LIMB_GROUPS:
        sm = np.isin(s_labels, sel_labels)
        tm = np.isin(t_labels, sel_labels)
        if sm.sum() < 8 or tm.sum() < 8:
            continue
        scale, R, t = _local_alignment_core(
            src[sm], s_labels[sm], tgt[tm], t_labels[tm], far, device=device)
        am = np.isin(s_labels, apply_labels)
        out[am] = scale * (R @ out[am].T).T + t
        if nrm_out is not None:
            nrm_out[am] = (R @ nrm_out[am].T).T
    return out, nrm_out


def align_by_shoulder(src: np.ndarray, s_normals: np.ndarray,
                      s_labels: np.ndarray, tgt: np.ndarray,
                      t_labels: np.ndarray,
                      shoulder_indices, k: int = 50) -> np.ndarray:
    """Shoulder-anchored arm offset (AlignByShoulder, Alignment.cpp:548-616;
    unused by the reference's main path but part of its surface): average
    the annotated shoulder-joint vertices per side, find the k nearest scan
    points among NECK/UPPER_ARM/TRUNCUS labels, and shift each whole arm
    along its (distance-scaled, sign-fixed) mean shoulder normal.
    shoulder_indices: [left_list, right_list] template vertex indices
    (models/parts.load_shoulder_joints). Host numpy, as in the JAX package."""
    out = src.copy()
    arm_groups = [
        ((P.LEFT_UPPER_ARM, P.LEFT_LOWER_ARM, P.LEFT_HAND), P.LEFT_UPPER_ARM),
        ((P.RIGHT_UPPER_ARM, P.RIGHT_LOWER_ARM, P.RIGHT_HAND),
         P.RIGHT_UPPER_ARM),
    ]
    for side, (arm_labels, upper) in enumerate(arm_groups):
        idx = np.asarray(shoulder_indices[side], np.int64)
        if len(idx) == 0:
            continue
        joint = src[idx].mean(0)
        nrm = s_normals[idx].mean(0)
        nrm = nrm / max(np.linalg.norm(nrm), 1e-12)

        cand = np.isin(t_labels, (P.NECK, upper, P.TRUNCUS))
        if not cand.any():
            continue
        d = np.linalg.norm(tgt[cand] - joint, axis=1)
        take = np.argsort(d)[:k]
        t_joint = tgt[cand][take].mean(0)
        dist = d[take].mean()
        step = nrm * dist
        if step @ (t_joint - joint) < 0:
            step = -step
        am = np.isin(s_labels, arm_labels)
        out[am] = out[am] + step
    return out


@dataclass
class AlignOutput:
    src: np.ndarray                 # aligned template vertices
    s_normals: Optional[np.ndarray]
    s_labels: np.ndarray
    tgt: np.ndarray                 # ground-removed scan
    t_normals: Optional[np.ndarray]
    t_faces: np.ndarray
    t_labels: np.ndarray
    scale: float
    R: np.ndarray
    t: np.ndarray


def align(src: np.ndarray, s_normals: Optional[np.ndarray],
          s_labels: np.ndarray, tgt: np.ndarray,
          t_normals: Optional[np.ndarray], t_faces: np.ndarray,
          view_ray: np.ndarray, dist_thres: float = 0.7, *,
          device) -> AlignOutput:
    """Full rigid template alignment (Align, Alignment.cpp:11-77):
    ground removal -> PCA init -> apply -> part transfer (1-NN) ->
    neck-barycenter offset -> per-limb local alignment. Spans
    ``deform.remove_ground``, ``deform.init_alignment``,
    ``deform.part_recog`` and ``deform.local_alignment``."""
    with span("deform.remove_ground"):
        g = remove_ground(tgt, t_normals, t_faces, dist_thres,
                          device=device)

    with span("deform.init_alignment"):
        scale, R, t = init_alignment(src, g.points, g.ground_ray, view_ray,
                                     device=device)
    src2 = scale * (R @ src.T).T + t
    nrm2 = (R @ s_normals.T).T if s_normals is not None else None

    with span("deform.part_recog"):
        t_labels = _host(part_recog(
            _f32(src2, device), torch.as_tensor(s_labels, device=device),
            _f32(g.points, device)))

    # neck barycenter offset (Alignment.cpp:56-64)
    sn = s_labels == P.NECK
    tn = t_labels == P.NECK
    if sn.any() and tn.any():
        offset = g.points[tn].mean(0) - src2[sn].mean(0)
        src2 = src2 + offset
        t = t + offset

    with span("deform.local_alignment"):
        src3, nrm3 = local_alignment(src2, nrm2, s_labels, g.points,
                                     t_labels, device=device)
    return AlignOutput(src3, nrm3, s_labels, g.points, g.normals, g.faces,
                       t_labels, scale, R, t)
