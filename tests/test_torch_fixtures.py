"""The port's scene fixtures against the JAX package's on the CPU:
uv_sphere (equal arrays), ring_cameras (K, R, t within 1e-6) and
make_scene (cameras within 1e-6; disparities with the rasterizer tests'
tolerance: coverage may differ on at most 0.1 % of the hit pixels, values
within rtol 1e-6 where both hit)."""

import inspect

import numpy as np
import pytest
import torch

from multiviewstitch_tpu.pipeline import fixtures as jfx
from multiviewstitch_tpu_torch.pipeline import fixtures as tfx
from test_torch_rasterizer import _assert_close

torch.set_num_threads(2)


def _cams_close(tc, jc):
    for name in ("K", "R", "t"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert (tc.width, tc.height) == (jc.width, jc.height)


def test_signatures_match_jax():
    for name in ("uv_sphere", "ring_cameras", "make_scene"):
        jp = list(inspect.signature(getattr(jfx, name)).parameters.items())
        tp = list(inspect.signature(getattr(tfx, name)).parameters.items())
        assert [(k, p.default) for k, p in jp] == \
            [(k, p.default) for k, p in tp if k != "device"], name


@pytest.mark.parametrize("seed", [0, 7])
def test_uv_sphere_matches_jax(seed):
    kw = dict(n_lat=12, n_lon=20, radius=0.8, bumps=0.15, seed=seed)
    tv, tf = tfx.uv_sphere(**kw)
    jv, jf = jfx.uv_sphere(**kw)
    assert tv.dtype == jv.dtype and tf.dtype == jf.dtype
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


RINGS = {
    "full ring": dict(n=6),
    "full ring, arc_center ignored": dict(n=5, arc_center_deg=30.0),
    "partial arc": dict(n=5, arc_deg=45.0),
    "arc_center": dict(n=4, arc_deg=60.0, arc_center_deg=-35.0),
    "look_at, radius, height": dict(
        n=5, radius=2.5, height=0.4, look_at=(0.1, -0.2, 2.5),
        arc_deg=90.0, arc_center_deg=80.0, width=200, img_height=150,
        length_focal=300.0),
}


@pytest.mark.parametrize("name", sorted(RINGS))
def test_ring_cameras_match_jax(name):
    kw = RINGS[name]
    _cams_close(tfx.ring_cameras(**kw, device="cpu"), jfx.ring_cameras(**kw))


def test_arc_center_turns_only_a_partial_arc():
    full = tfx.ring_cameras(4, arc_center_deg=45.0, device="cpu")
    assert torch.equal(full.R, tfx.ring_cameras(4, device="cpu").R)
    arc = tfx.ring_cameras(3, arc_deg=30.0, arc_center_deg=45.0,
                           device="cpu")
    # the middle camera sits at 45 degrees on the circle of radius 2
    centre = -arc.R[1].T @ arc.t[1]
    np.testing.assert_allclose(centre.numpy(),
                               [2 * np.cos(np.pi / 4), 0, 2 * np.sin(
                                   np.pi / 4)], atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(cam_radius=2.4, arc_deg=60.0, arc_center_deg=20.0, seed=3),
    dict(cam_radius=1.8),
], ids=["partial arc", "full ring"])
def test_make_scene_matches_jax(kw):
    kw = dict(n_frames=3, width=64, height=48, n_lat=16, n_lon=24, **kw)
    ts = tfx.make_scene(**kw, device="cpu")
    js = jfx.make_scene(**kw)
    np.testing.assert_array_equal(ts.vertices, js.vertices)
    np.testing.assert_array_equal(ts.faces, js.faces)
    _cams_close(ts.cams, js.cams)
    got = ts.disparity.numpy()
    assert (got > 0).mean() > 0.05
    _assert_close(got, js.disparity)
