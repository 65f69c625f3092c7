"""The port's solvers/alignment against the JAX package's on the same numpy
inputs. Tolerance: ground removal keeps the same points and faces, ground
ray within 1e-5; init_alignment's (s, R, t) within 1e-4; the aligned
template within 1e-4 (the port's 1-NN labels take exact differences, JAX's
the expanded square, so a near-tie label may differ: >= 99.9 % equal)."""

import numpy as np
import pytest
import torch

from multiviewstitch_tpu.models.template_body import (make_template,
                                                      pose_template)
from multiviewstitch_tpu.solvers import alignment as JA
from multiviewstitch_tpu_torch.cli import demo_scan
from multiviewstitch_tpu_torch.solvers import alignment as TA
from test_alignment import add_ground

torch.set_num_threads(2)

VIEW_RAY = np.array([0.0, 0.0, 1.0])


@pytest.fixture(scope="module")
def template():
    return make_template()


def _grounded_scan(template, arm=20.0, s=1.1, t=(0.2, 0.05, -0.1)):
    v, f, lbl = template
    posed = pose_template(v, lbl, arm_angle_deg=arm)
    sv = (s * posed + np.asarray(t)).astype(np.float32)
    return add_ground(sv, f, y=sv[:, 1].min() - 0.02)


@pytest.mark.parametrize("scan", ["template + ground", "posed + ground",
                                  "demo scan"])
def test_remove_ground_matches_jax(template, scan):
    if scan == "template + ground":
        pv, pf = add_ground(template[0], template[1],
                            y=template[0][:, 1].min() - 0.02)
    elif scan == "posed + ground":
        pv, pf = _grounded_scan(template)
    else:
        pv, pf = demo_scan()
    want = JA.remove_ground(pv, None, pf)
    got = TA.remove_ground(pv, None, pf, device="cpu")
    assert np.array_equal(got.points, want.points)
    assert np.array_equal(got.faces, want.faces)
    assert got.normals is None
    np.testing.assert_allclose(got.ground_ray, want.ground_ray, atol=1e-5)


@pytest.mark.parametrize("case", ["rotated template", "demo scan"])
def test_init_alignment_matches_jax(template, case):
    v = template[0]
    if case == "rotated template":
        ang = np.radians(30)
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        tgt = (1.2 * (R @ v.T).T + np.array([0.3, -0.2, 0.5])).astype(
            np.float32)
        ground, view = R @ np.array([0.0, -1.0, 0.0]), R @ VIEW_RAY
    else:
        sv, sf = demo_scan()
        g = JA.remove_ground(sv, None, sf)
        tgt, ground, view = g.points, g.ground_ray, VIEW_RAY
    js, jR, jt = JA.init_alignment(v, tgt, ground, view)
    ts, tR, tt = TA.init_alignment(v, tgt, ground, view, device="cpu")
    assert abs(ts - js) < 1e-4
    np.testing.assert_allclose(tR, jR, atol=1e-4)
    np.testing.assert_allclose(tt, jt, atol=1e-4)
    assert np.linalg.det(tR) > 0.999


def test_local_alignment_matches_jax(template):
    from multiviewstitch_tpu_torch.ops.mesh_normals import vertex_normals
    v, f, lbl = template
    tgt = pose_template(v, lbl, arm_angle_deg=25.0, leg_spread_deg=6.0)
    nrm = vertex_normals(torch.as_tensor(v), torch.as_tensor(f)).numpy()
    jo, jn = JA.local_alignment(v.copy(), nrm, lbl, tgt, lbl)
    to, tn = TA.local_alignment(v.copy(), nrm, lbl, tgt, lbl, device="cpu")
    np.testing.assert_allclose(to, jo, atol=1e-4)
    np.testing.assert_allclose(tn, jn, atol=1e-4)
    assert not np.allclose(to, v)


def test_align_matches_jax(template):
    v, f, lbl = template
    from multiviewstitch_tpu_torch.ops.mesh_normals import vertex_normals
    nrm = vertex_normals(torch.as_tensor(v), torch.as_tensor(f)).numpy()
    sv, sf = _grounded_scan(template)
    want = JA.align(v, nrm, lbl, sv, None, sf, VIEW_RAY)
    got = TA.align(v, nrm, lbl, sv, None, sf, VIEW_RAY, device="cpu")
    assert np.array_equal(got.tgt, want.tgt)
    assert np.array_equal(got.t_faces, want.t_faces)
    assert (got.t_labels == want.t_labels).mean() >= 0.999
    assert abs(got.scale - want.scale) < 1e-4
    np.testing.assert_allclose(got.R, want.R, atol=1e-4)
    np.testing.assert_allclose(got.src, want.src, atol=1e-4)
    np.testing.assert_allclose(got.s_normals, want.s_normals, atol=1e-4)


def test_align_by_shoulder_matches_jax(template):
    v, f, lbl = template
    rng = np.random.default_rng(3)
    nrm = rng.normal(size=v.shape)
    tgt = (v + np.array([0.0, -0.03, 0.02])).astype(np.float32)
    joints = [list(np.nonzero(lbl == 2)[0][:6]),
              list(np.nonzero(lbl == 5)[0][:6])]
    want = JA.align_by_shoulder(v, nrm, lbl, tgt, lbl, joints, k=20)
    got = TA.align_by_shoulder(v, nrm, lbl, tgt, lbl, joints, k=20)
    assert np.array_equal(got, want) and not np.array_equal(got, v)
