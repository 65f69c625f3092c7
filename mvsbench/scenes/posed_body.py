"""A body scanner: a posed humanoid seen by a full ring of portrait
cameras, twice, the second ring's world moved by one similarity.

The body is a frozen copy of the port's synthetic template (capsule limbs
bridged at the joints, 1,952 vertices, the reference's 16-part ids),
posed with the arms lowered and the legs spread. Traffic keys: frames,
width, height, cam_radius, frame_fill (the body's height as a share of
the image height at ``cam_radius``), arm_deg, leg_deg, ring_offset_deg
(the second ring is turned by it against the first), scale, yaw_deg,
translation. The seed turns both rings by one angle drawn below one frame
step, so every seed gives the same sizes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..fixtures import move_scene, render_mesh, ring_cameras, textured_views
from ..geometry import Sim, yaw_sim
from . import Frames, Scene

HEAD, NECK = 0, 1
LEFT_UPPER_ARM, LEFT_LOWER_ARM, LEFT_HAND = 2, 3, 4
RIGHT_UPPER_ARM, RIGHT_LOWER_ARM, RIGHT_HAND = 5, 6, 7
LEFT_THIGH, LEFT_SHANK, LEFT_FOOT = 8, 9, 10
RIGHT_THIGH, RIGHT_SHANK, RIGHT_FOOT = 11, 12, 13
TRUNCUS, HIP = 14, 15
BODY_HEIGHT = 1.8


def _capsule(p0, p1, radius, n_seg=8, n_ring=8):
    """Capsule mesh from p0 to p1 -> (verts, faces)."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    z = axis / max(length, 1e-9)
    x = np.cross(z, [0.0, 0.0, 1.0])
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)

    verts = []
    # rings along the cylinder + hemispherical caps
    tv = np.linspace(0, 1, n_seg)
    phis = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    # bottom cap pole
    verts.append(p0 - radius * z)
    cap = 3
    for c in range(1, cap):
        ang = 0.5 * np.pi * c / cap
        r = radius * np.sin(ang)
        zz = -radius * np.cos(ang)
        for ph in phis:
            verts.append(p0 + zz * z + r * (np.cos(ph) * x + np.sin(ph) * y))
    for t in tv:
        c = p0 + t * length * z
        for ph in phis:
            verts.append(c + radius * (np.cos(ph) * x + np.sin(ph) * y))
    for c in range(1, cap):
        ang = 0.5 * np.pi * (1 - c / cap)
        r = radius * np.sin(ang)
        zz = radius * np.cos(ang)
        for ph in phis:
            verts.append(p1 + zz * z + r * (np.cos(ph) * x + np.sin(ph) * y))
    verts.append(p1 + radius * z)
    verts = np.asarray(verts, np.float32)

    faces = []
    n_rings_total = 2 * (cap - 1) + n_seg
    # pole fans
    first_ring = 1
    for j in range(n_ring):
        faces.append([0, first_ring + (j + 1) % n_ring, first_ring + j])
    last_ring = 1 + (n_rings_total - 1) * n_ring
    apex = len(verts) - 1
    for j in range(n_ring):
        faces.append([apex, last_ring + j, last_ring + (j + 1) % n_ring])
    # ring strips
    for r in range(n_rings_total - 1):
        a = 1 + r * n_ring
        b = 1 + (r + 1) * n_ring
        for j in range(n_ring):
            j2 = (j + 1) % n_ring
            faces.append([a + j, b + j, b + j2])
            faces.append([a + j, b + j2, a + j2])
    return verts, np.asarray(faces, np.int32)


# (part id, p0, p1, radius) — proportions of a ~1.75 m body in T-pose
_SEGMENTS = [
    (HIP,             (0.00, 0.95, 0.0), (0.00, 1.05, 0.0), 0.16),
    (TRUNCUS,         (0.00, 1.05, 0.0), (0.00, 1.45, 0.0), 0.15),
    (NECK,            (0.00, 1.45, 0.0), (0.00, 1.55, 0.0), 0.06),
    (HEAD,            (0.00, 1.55, 0.0), (0.00, 1.72, 0.0), 0.10),
    (LEFT_UPPER_ARM,  (0.17, 1.40, 0.0), (0.45, 1.40, 0.0), 0.05),
    (LEFT_LOWER_ARM,  (0.45, 1.40, 0.0), (0.70, 1.40, 0.0), 0.04),
    (LEFT_HAND,       (0.70, 1.40, 0.0), (0.80, 1.40, 0.0), 0.04),
    (RIGHT_UPPER_ARM, (-0.17, 1.40, 0.0), (-0.45, 1.40, 0.0), 0.05),
    (RIGHT_LOWER_ARM, (-0.45, 1.40, 0.0), (-0.70, 1.40, 0.0), 0.04),
    (RIGHT_HAND,      (-0.70, 1.40, 0.0), (-0.80, 1.40, 0.0), 0.04),
    (LEFT_THIGH,      (0.10, 0.95, 0.0), (0.10, 0.50, 0.0), 0.08),
    (LEFT_SHANK,      (0.10, 0.50, 0.0), (0.10, 0.10, 0.0), 0.06),
    (LEFT_FOOT,       (0.10, 0.10, 0.0), (0.10, 0.02, 0.10), 0.05),
    (RIGHT_THIGH,     (-0.10, 0.95, 0.0), (-0.10, 0.50, 0.0), 0.08),
    (RIGHT_SHANK,     (-0.10, 0.50, 0.0), (-0.10, 0.10, 0.0), 0.06),
    (RIGHT_FOOT,      (-0.10, 0.10, 0.0), (-0.10, 0.02, 0.10), 0.05),
]


# joints to weld so the template is one edge-connected component
_JOINTS = [
    (HIP, TRUNCUS), (TRUNCUS, NECK), (NECK, HEAD),
    (TRUNCUS, LEFT_UPPER_ARM), (LEFT_UPPER_ARM, LEFT_LOWER_ARM),
    (LEFT_LOWER_ARM, LEFT_HAND),
    (TRUNCUS, RIGHT_UPPER_ARM), (RIGHT_UPPER_ARM, RIGHT_LOWER_ARM),
    (RIGHT_LOWER_ARM, RIGHT_HAND),
    (HIP, LEFT_THIGH), (LEFT_THIGH, LEFT_SHANK),
    (LEFT_SHANK, LEFT_FOOT),
    (HIP, RIGHT_THIGH), (RIGHT_THIGH, RIGHT_SHANK),
    (RIGHT_SHANK, RIGHT_FOOT),
]


def make_template(n_seg: int = 8, n_ring: int = 10
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the synthetic template -> (verts [V,3], faces [F,3],
    labels [V] int32 in the reference's PART enum). Capsule segments are
    bridged at the joints so the mesh is one edge-connected component
    (the alignment stage's RetainConnectRegion must keep the whole body)."""
    all_v, all_f, all_l = [], [], []
    off = 0
    for pid, p0, p1, r in _SEGMENTS:
        v, f = _capsule(p0, p1, r, n_seg, n_ring)
        all_v.append(v)
        all_f.append(f + off)
        all_l.append(np.full(len(v), pid, np.int32))
        off += len(v)
    verts = np.concatenate(all_v)
    faces = np.concatenate(all_f)
    labels = np.concatenate(all_l)

    bridges = []
    for pa, pb in _JOINTS:
        ia = np.nonzero(labels == pa)[0]
        ib = np.nonzero(labels == pb)[0]
        d2 = ((verts[ia][:, None, :] - verts[ib][None]) ** 2).sum(-1)
        k = np.unravel_index(np.argmin(d2), d2.shape)
        a1, b1 = ia[k[0]], ib[k[1]]
        # second-closest partners for real triangles
        a2 = ia[np.argsort(d2[:, k[1]])[1]]
        b2 = ib[np.argsort(d2[k[0], :])[1]]
        bridges.append([a1, b1, a2])
        bridges.append([b1, b2, a2])
    faces = np.concatenate([faces, np.asarray(bridges, np.int32)])
    return verts, faces, labels


def pose_template(verts: np.ndarray, labels: np.ndarray,
                  arm_angle_deg: float = 0.0,
                  leg_spread_deg: float = 0.0) -> np.ndarray:
    """Simple articulation for tests: rotate arms down / spread legs about
    their shoulder/hip anchors. Returns new vertices."""
    out = verts.copy()

    def rotz(deg):
        a = np.radians(deg)
        return np.array([[np.cos(a), -np.sin(a), 0],
                         [np.sin(a), np.cos(a), 0], [0, 0, 1]])

    groups = [
        ((LEFT_UPPER_ARM, LEFT_LOWER_ARM, LEFT_HAND),
         np.array([0.17, 1.40, 0.0]), rotz(-arm_angle_deg)),
        ((RIGHT_UPPER_ARM, RIGHT_LOWER_ARM, RIGHT_HAND),
         np.array([-0.17, 1.40, 0.0]), rotz(arm_angle_deg)),
        ((LEFT_THIGH, LEFT_SHANK, LEFT_FOOT),
         np.array([0.10, 0.95, 0.0]), rotz(leg_spread_deg)),
        ((RIGHT_THIGH, RIGHT_SHANK, RIGHT_FOOT),
         np.array([-0.10, 0.95, 0.0]), rotz(-leg_spread_deg)),
    ]
    for pids, anchor, R in groups:
        m = np.isin(labels, pids)
        out[m] = (R @ (out[m] - anchor).T).T + anchor
    return out


def generate(traffic: dict, seed: int, device) -> Scene:
    tv, tf, tl = make_template()
    posed = pose_template(tv, tl, arm_angle_deg=traffic["arm_deg"],
                          leg_spread_deg=traffic["leg_deg"]).astype(
                              np.float32)
    center = posed.mean(0)
    n, h = traffic["frames"], traffic["height"]
    phase = float(np.random.default_rng(int(seed)).uniform(0.0, 360.0 / n))
    gt = yaw_sim(traffic["scale"], traffic["yaw_deg"],
                 traffic["translation"])
    seqs = []
    for k, T in enumerate((None, gt)):
        cams = ring_cameras(
            n, radius=traffic["cam_radius"], width=traffic["width"],
            height=h, focal=float(traffic["frame_fill"] * h *
                                  traffic["cam_radius"] / BODY_HEIGHT),
            look_at=tuple(center.tolist()), cam_height=float(center[1]),
            phase_deg=phase + k * traffic["ring_offset_deg"], device=device)
        v, c = (posed, cams) if T is None else move_scene(posed, cams, T)
        disp = render_mesh(v, tf, c)
        seqs.append(Frames(textured_views(c, disp, None if T is None
                                          else T.inverse()), disp, c))
    return Scene(seqs, v, tf, [gt, Sim(1.0, np.eye(3), np.zeros(3))])
