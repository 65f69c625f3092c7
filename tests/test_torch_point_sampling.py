"""K2's plain version (sample_oriented_points_reference, the port's CPU
path of sample_oriented_points) and visibility_filter against the JAX
package on the same numpy inputs.

Tolerances: conf and valid agree on >= 99.9 % of samples (floor(x+0.5)
ties under a different float-op order may move one neighbour's vote);
points atol 1e-5 and normals atol 1e-4 (float32 unprojection and a
normalised cross product of differences)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiviewstitch_tpu.core.cameras import CameraBatch as JCams
from multiviewstitch_tpu.ops import point_sampling as jps
from multiviewstitch_tpu.pipeline.fixtures import make_scene as j_make_scene
from multiviewstitch_tpu_torch.interop import cameras_from_numpy
from multiviewstitch_tpu_torch.ops import point_sampling as tps

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    sc = j_make_scene(n_frames=5, width=96, height=72, bumps=0.15,
                      n_lat=32, n_lon=48, arc_deg=60.0)
    return _scene_arrays(sc, 0.005)


def _scene_arrays(sc, noise):
    c = sc.cams
    rng = np.random.default_rng(0)
    d = np.array(sc.disparity)
    d = (d * (1.0 + noise * rng.normal(size=d.shape))).astype(np.float32)
    return d, np.array(c.K), np.array(c.R), np.array(c.t), c.width, \
        c.height


def _matches_jax(scene, fn, **kw):
    d, K, R, t, w, h = scene
    jop = jps.sample_oriented_points(jnp.asarray(d), JCams(K, R, t, w, h),
                                     min_dsp=1e-3, max_dsp=10.0, **kw)
    top = fn(torch.as_tensor(d), cameras_from_numpy(K, R, t, w, h, "cpu"),
             min_dsp=1e-3, max_dsp=10.0, **kw)
    jconf, tconf = np.asarray(jop.conf), top.conf.numpy()
    conf_agree = (jconf == tconf).mean()
    valid_agree = (np.asarray(jop.valid) == top.valid.numpy()).mean()
    print(f"conf agree {conf_agree:.5f}, valid agree {valid_agree:.5f}")
    assert conf_agree >= 0.999
    assert valid_agree >= 0.999
    assert top.valid.sum() > 0.2 * top.valid.numel()
    np.testing.assert_allclose(top.points.numpy(), np.asarray(jop.points),
                               atol=1e-5)
    jn = np.asarray(jop.normals)
    np.testing.assert_allclose(top.normals.numpy(), jn, atol=1e-4)
    return top


@pytest.mark.parametrize("kw", [
    dict(sample_radius=2, nbr_num=1, nbr_step=1, dsp_err=0.05, conf_min=0.5),
    dict(sample_radius=3, nbr_num=2, nbr_step=1, dsp_err=0.01, conf_min=0.6),
])
def test_sample_oriented_points_matches_jax(scene, kw):
    _matches_jax(scene, tps.sample_oriented_points, **kw)


def test_reference_matches_jax_at_nbr_num_5_step_2():
    # 12 frames, so frames n +- 2, 4, ..., 10 exist for the middle ones
    sc = j_make_scene(n_frames=12, width=96, height=72, bumps=0.15,
                      n_lat=32, n_lon=48, arc_deg=60.0)
    top = _matches_jax(_scene_arrays(sc, 0.002),
                       tps.sample_oriented_points_reference, sample_radius=2,
                       nbr_num=5, nbr_step=2, dsp_err=0.01, conf_min=0.6)
    conf = top.conf.numpy()
    assert ((conf > 0) & (conf < 1)).any()


@pytest.mark.parametrize("r", [1, 2, 3])
def test_reference_matches_jax_with_valid_pixels_on_every_border(r):
    # cameras 0.7 from the centre of a sphere of radius ~0.5: the surface
    # fills every image, so the border samples' tangents wrap (roll)
    sc = j_make_scene(n_frames=3, width=96, height=72, bumps=0.05,
                      n_lat=32, n_lon=48, arc_deg=30.0, cam_radius=0.7)
    scene = _scene_arrays(sc, 0.0)
    d = scene[0]
    assert all((e > 0).all() for e in (d[:, 0], d[:, -1], d[:, :, 0],
                                       d[:, :, -1]))
    top = _matches_jax(scene, tps.sample_oriented_points_reference,
                       sample_radius=r, nbr_num=1, nbr_step=1, dsp_err=0.05,
                       conf_min=0.0)
    keep = top.valid.numpy().reshape(3, len(range(0, 72, r)), -1)
    assert keep[:, 0].all() and keep[:, -1].all()
    assert keep[:, :, 0].all() and keep[:, :, -1].all()


def test_visibility_filter_matches_jax(scene):
    d, K, R, t, w, h = scene
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(400, 3)) * 0.6).astype(np.float32)
    valid = rng.random(400) < 0.9
    jv = np.asarray(jps.visibility_filter(jnp.asarray(pts),
                                          jnp.asarray(valid),
                                          JCams(K, R, t, w, h)))
    tv = tps.visibility_filter(torch.as_tensor(pts), torch.as_tensor(valid),
                               cameras_from_numpy(K, R, t, w, h, "cpu"))
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert 0 < jv.sum() < valid.sum()
