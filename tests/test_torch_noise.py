"""Noise fixtures and noise robustness: the port's sensor_noise,
inject_outlier_matches and shade_views against the JAX package's, ports of
tests/test_noise_robustness.py's property tests, and the port's align /
RANSAC under that noise (the JAX file is `slow`; these run at the demo
size, 128x96).

Tolerances: sensor_noise and inject_outlier_matches byte-identical (the
same numpy code drawing from the same default_rng); shade_views within
1e-5; align at noise 1x and 2x within the JAX test's limits (s 8 %,
rotation 5 deg, translation 0.15); RANSAC under 30 % gross outliers within
2 %, 1 deg and 0.03."""

import numpy as np
import pytest
import torch

from multiviewstitch_tpu.pipeline import fixtures as jfx
from multiviewstitch_tpu_torch.core.transforms import rotation_angle_deg
from multiviewstitch_tpu_torch.interop import cameras_from_numpy
from multiviewstitch_tpu_torch.pipeline import fixtures as fx

torch.set_num_threads(2)


def _images(seed=0):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 255, size=(2, 40, 50)).astype(np.float32)
    d = rng.uniform(0.2, 0.4, size=(2, 40, 50)).astype(np.float32)
    d[:, :5] = 0.0                                  # invalid rows
    return g, d


@pytest.mark.parametrize("level,seed", [(0.0, 0), (1.0, 0), (2.0, 3)])
def test_sensor_noise_is_byte_identical_to_jax(level, seed):
    g, d = _images()
    got = fx.sensor_noise(g, d, level, seed=seed)
    want = jfx.sensor_noise(g, d, level, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_inject_outlier_matches_is_byte_identical_to_jax():
    rng = np.random.default_rng(4)
    uv1 = rng.integers(0, 160, size=(300, 2)).astype(np.int32)
    uv2 = rng.integers(0, 120, size=(300, 2)).astype(np.int32)
    mask = rng.random(300) < 0.7
    for frac in (0.0, 0.3):
        got = fx.inject_outlier_matches(uv1, uv2, mask, frac, 160, 120,
                                        seed=5)
        want = jfx.inject_outlier_matches(uv1, uv2, mask, frac, 160, 120,
                                          seed=5)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_shade_views_matches_jax():
    js = jfx.make_scene(n_frames=3, width=64, height=48, bumps=0.12,
                        n_lat=24, n_lon=32)
    c = js.cams
    ts = fx.Scene(np.asarray(js.vertices), np.asarray(js.faces),
                  cameras_from_numpy(np.asarray(c.K), np.asarray(c.R),
                                     np.asarray(c.t), c.width, c.height,
                                     "cpu"),
                  torch.as_tensor(np.array(js.disparity)), None)
    got = fx.shade_views(ts).numpy()
    want = jfx.shade_views(js)
    assert (want > 0).mean() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_inject_outlier_matches_shapes():
    uv1 = np.zeros((50, 2), np.int32)
    uv2 = np.zeros((50, 2), np.int32)
    uv2n, bad = fx.inject_outlier_matches(uv1, uv2, np.ones(50, bool), 0.2,
                                          160, 120)
    assert len(bad) == 10
    assert (uv2n[bad] != 0).any()
    untouched = np.setdiff1d(np.arange(50), bad)
    np.testing.assert_array_equal(uv2n[untouched], uv2[untouched])


def test_sensor_noise_properties():
    rng = np.random.default_rng(0)
    g = rng.uniform(0, 255, size=(2, 40, 50)).astype(np.float32)
    d = rng.uniform(0.2, 0.4, size=(2, 40, 50)).astype(np.float32)
    g0, _ = fx.sensor_noise(g, d, 0.0)
    np.testing.assert_array_equal(g0, g)
    g1, d1 = fx.sensor_noise(g, d, 1.0)
    assert not np.allclose(g1, g)
    assert not np.allclose(d1, d)
    # quantization: a discrete value set
    assert len(np.unique(np.round(d1[d1 > 0], 6))) < d1.size / 3
    assert (g1 >= 0).all() and (g1 <= 255).all()
    dropped = ((d1 == 0) & (d > 0)).mean()
    assert 0 < dropped < 0.02


def noisy_demo(level, seed=0, device="cpu"):
    """The CLI demo's two sequences under sensor_noise (seed + k for
    sequence k). Returns (sequences, gt)."""
    from multiviewstitch_tpu_torch.cli import build_demo_sequences
    from multiviewstitch_tpu_torch.pipeline.align_seq import Sequence
    seqs, gt, _, _ = build_demo_sequences(device)
    out = []
    for k, s in enumerate(seqs):
        g, d = fx.sensor_noise(s.gray.cpu().numpy(),
                               s.disparity.cpu().numpy(), level,
                               seed=seed + k)
        out.append(Sequence(torch.as_tensor(g, device=device),
                            torch.as_tensor(d, device=device), s.cams))
    return out, gt


@pytest.mark.parametrize("level", [1.0, 2.0])
def test_align_survives_sensor_noise(level):
    from multiviewstitch_tpu_torch.cli import demo_config
    from multiviewstitch_tpu_torch.pipeline.align_seq import align_sequences
    seqs, gt = noisy_demo(level)
    T = align_sequences(seqs, demo_config(), seed=0).transforms[0]
    print(f"noise {level}: s {float(T.s):.4f}, rotation "
          f"{rotation_angle_deg(T.R, gt.R):.3f} deg")
    np.testing.assert_allclose(float(T.s), float(gt.s), rtol=0.08)
    assert rotation_angle_deg(T.R, gt.R) < 5.0
    assert np.linalg.norm(T.t.numpy() - gt.t.numpy()) < 0.15


def test_srt_ransac_survives_gross_outliers():
    """30 % uniformly corrupted correspondences do not move the RANSAC SRT
    (the RemoveOutliers contract, Processor.cpp:196-259)."""
    from multiviewstitch_tpu_torch.solvers.srt import (
        RansacStream, estimate_srt_ransac, stream_key)
    rng = np.random.default_rng(3)
    p1 = rng.uniform(-0.5, 0.5, size=(200, 3)).astype(np.float32)
    p1[:, 2] += 3.0
    s, th = 1.2, np.radians(20)
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    t = np.array([0.1, -0.2, 0.15], np.float32)
    p2 = (s * (R @ p1.T).T + t).astype(np.float32)
    bad = rng.random(200) < 0.3
    p2[bad] += rng.uniform(0.5, 2.0, size=(int(bad.sum()), 3)).astype(
        np.float32) * np.sign(rng.normal(size=(int(bad.sum()), 3))).astype(
        np.float32)
    K = np.array([[200.0, 0, 80.0], [0, 200.0, 60.0], [0, 0, 1]])
    cam = cameras_from_numpy(K, np.eye(3), np.zeros(3), 160, 120, "cpu")
    stream = RansacStream(stream_key(0, 0), torch.tensor(0))
    T, _ = estimate_srt_ransac(torch.as_tensor(p1), torch.as_tensor(p2),
                               torch.ones(200, dtype=torch.bool), cam, cam,
                               stream, iter_num=256)
    assert abs(float(T.s) - s) / s < 0.02
    assert rotation_angle_deg(T.R, R) < 1.0
    assert np.linalg.norm(T.t.numpy() - t) < 0.03
