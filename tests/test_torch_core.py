"""Cameras and similarity transforms: the port against the JAX package on
the same numpy inputs. Tolerance: atol 1e-5 (float32 math in the same
operand order; the residue is the two libraries' own rounding)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiviewstitch_tpu.core import cameras as jc
from multiviewstitch_tpu.core import transforms as jt
from multiviewstitch_tpu_torch.core import cameras as tc
from multiviewstitch_tpu_torch.core import transforms as tt
from multiviewstitch_tpu_torch.interop import (cameras_from_numpy,
                                               similarity_from_numpy,
                                               sequence_from_numpy)

torch.set_num_threads(2)


def _rig(n=3, seed=0):
    rng = np.random.default_rng(seed)
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = rng.uniform(80, 120, n)
    K[:, 1, 1] = rng.uniform(80, 120, n)
    K[:, 0, 2] = 31.5
    K[:, 1, 2] = 23.5
    K[:, 2, 2] = 1.0
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                  for _ in range(n)]).astype(np.float32)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return K, R, t


def test_project_unproject_match_jax():
    K, R, t = _rig()
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(3, 50, 3)).astype(np.float32) + [0, 0, 4]
    jcam = jc.CameraBatch(jnp.asarray(K[:, None]), jnp.asarray(R[:, None]),
                          jnp.asarray(t[:, None]), 64, 48)
    tcam = cameras_from_numpy(K, R, t, 64, 48, "cpu").expand_dims(1)
    juv, jz = jc.project(jcam, jnp.asarray(pts))
    tuv, tz = tc.project(tcam, torch.as_tensor(pts))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5)
    depth = rng.uniform(1, 3, size=(3, 50)).astype(np.float32)
    uv = rng.uniform(0, 60, size=(3, 50, 2)).astype(np.float32)
    jp = jc.unproject(jcam, jnp.asarray(uv), jnp.asarray(depth))
    tp = tc.unproject(tcam, torch.as_tensor(uv), torch.as_tensor(depth))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)


def test_unproject_depth_map_and_pixel_grid_match_jax():
    K, R, t = _rig(2, seed=3)
    rng = np.random.default_rng(2)
    disp = rng.uniform(0.0, 0.6, size=(2, 12, 16)).astype(np.float32)
    for i in range(2):
        jcam = jc.CameraBatch(jnp.asarray(K[i]), jnp.asarray(R[i]),
                              jnp.asarray(t[i]), 16, 12)
        jp, jv = jc.unproject_depth_map(jcam, jnp.asarray(disp[i]), 0.1, 0.5)
        tcam = cameras_from_numpy(K[i], R[i], t[i], 16, 12, "cpu")
        tp, tv = tc.unproject_depth_map(tcam, torch.as_tensor(disp[i]),
                                        0.1, 0.5)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_array_equal(tc.pixel_grid(5, 7, device="cpu").numpy(),
                                  np.asarray(jc.pixel_grid(5, 7)))
    cams = cameras_from_numpy(K, R, t, 16, 12, "cpu")
    np.testing.assert_allclose(
        cams.centers().numpy(),
        np.asarray(jc.CameraBatch(K, R, t, 16, 12).centers()), atol=1e-5)


def test_similarity_algebra_matches_jax():
    rng = np.random.default_rng(4)
    Rs = [np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
          for _ in range(2)]
    ts = [rng.normal(size=3).astype(np.float32) for _ in range(2)]
    ss = [np.float32(1.3), np.float32(0.8)]
    ja = [jt.Similarity(jnp.asarray(s), jnp.asarray(R), jnp.asarray(t))
          for s, R, t in zip(ss, Rs, ts)]
    ta = [similarity_from_numpy(s, R, t, "cpu") for s, R, t in zip(ss, Rs, ts)]
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    for jT, tT in ((jt.compose(*ja), tt.compose(*ta)),
                   (jt.inverse(ja[0]), tt.inverse(ta[0]))):
        np.testing.assert_allclose(float(tT.s), float(jT.s), rtol=1e-6)
        np.testing.assert_allclose(tT.R.numpy(), np.asarray(jT.R), atol=1e-5)
        np.testing.assert_allclose(tT.t.numpy(), np.asarray(jT.t), atol=1e-5)
        np.testing.assert_allclose(
            tt.apply_points(tT, torch.as_tensor(pts)).numpy(),
            np.asarray(jt.apply_points(jT, jnp.asarray(pts))), atol=1e-5)
        np.testing.assert_allclose(
            tt.rotate_normals(tT, torch.as_tensor(pts)).numpy(),
            np.asarray(jt.rotate_normals(jT, jnp.asarray(pts))), atol=1e-5)
    ident = tt.Similarity.identity((2,), device="cpu")
    assert ident.R.shape == (2, 3, 3) and float(ident.s.sum()) == 2.0


@pytest.mark.parametrize("angle", [0.0, 0.3, -1.2])
def test_rotation_about_axis_matches_jax(angle):
    axis = np.asarray([0.3, -0.5, 0.8], np.float32)
    axis /= np.linalg.norm(axis)
    jR = np.asarray(jt.rotation_about_axis(jnp.asarray(axis),
                                           jnp.float32(angle)))
    tR = tt.rotation_about_axis(torch.as_tensor(axis),
                                torch.tensor(angle)).numpy()
    np.testing.assert_allclose(tR, jR, atol=1e-6)
    assert abs(tt.rotation_angle_deg(tR, np.eye(3, dtype=np.float32)) -
               abs(np.degrees(angle))) < 1e-3


def test_interop_sequence_and_device_moves():
    K, R, t = _rig(2)
    g = np.zeros((2, 4, 5), np.float32)
    seq = sequence_from_numpy(g, g + 0.5, K, R, t, 5, 4, "cpu")
    assert seq.gray.dtype == torch.float32 and seq.cams.width == 5
    moved = seq.cams.to("cpu")
    assert moved.K.shape == (2, 3, 3)
    assert seq.cams[1].K.shape == (3, 3)
    assert len(seq.cams) == 2
