"""K2's plain version (the port's CPU path of sample_oriented_points) and
visibility_filter against the JAX package on the same numpy inputs.

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
    c = sc.cams
    rng = np.random.default_rng(0)
    d = np.array(sc.disparity)
    d = (d * (1.0 + 0.005 * rng.normal(size=d.shape))).astype(np.float32)
    return d, np.array(c.K), np.array(c.R), np.array(c.t), c.width, \
        c.height


@pytest.mark.parametrize("kw", [
    dict(sample_radius=2, nbr_num=1, nbr_step=1, dsp_err=0.05, conf_min=0.5),
    dict(sample_radius=3, nbr_num=2, nbr_step=1, dsp_err=0.01, conf_min=0.6),
])
def test_sample_oriented_points_matches_jax(scene, kw):
    d, K, R, t, w, h = scene
    jop = jps.sample_oriented_points(jnp.asarray(d), JCams(K, R, t, w, h),
                                     min_dsp=1e-3, max_dsp=10.0, **kw)
    top = tps.sample_oriented_points(
        torch.as_tensor(d), cameras_from_numpy(K, R, t, w, h, "cpu"),
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
