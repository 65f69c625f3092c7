"""Segmentation and the AllSeqProj trim: the port against the JAX package
on the same numpy inputs made from a seed, and the ``segment`` mask in the
port's prep.

Tolerance: none. The disparity mask, the colour-EM masks (on images whose
clusters are well apart, so no pixel sits on a distance tie that the two
libraries' summation orders could break differently), the AllSeqProj keep
set and faces are all equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiviewstitch_tpu.core.transforms import Similarity as JSim
from multiviewstitch_tpu.ops import segmentation as jseg
from multiviewstitch_tpu.pipeline.fixtures import make_scene as j_make_scene
from multiviewstitch_tpu_torch.interop import (cameras_from_numpy,
                                               similarity_from_numpy)
from multiviewstitch_tpu_torch.ops import segmentation as tseg

torch.set_num_threads(2)


def test_foreground_from_disparity_matches_jax():
    rng = np.random.default_rng(0)
    d = rng.uniform(-0.2, 1.4, (3, 24, 32)).astype(np.float32)
    d[0, 0, :4] = [0.1, 1.0, 0.0999999, 1.0000001]    # range ends
    got = tseg.foreground_from_disparity(torch.as_tensor(d), 0.1, 1.0)
    want = np.asarray(jseg.foreground_from_disparity(jnp.asarray(d), 0.1,
                                                     1.0))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, :4].tolist() == [True, True, False, False]


def _bright_object(seed):
    rng = np.random.default_rng(seed)
    h, w = 60, 80
    img = np.zeros((h, w), np.float32) + 0.1
    img += rng.normal(size=(h, w)).astype(np.float32) * 0.01
    img[20:40, 30:55] = 0.9
    return img


def _textured_clutter(seed):
    """tests/test_utils_segmentation.py's RGB scene: textured reddish
    ellipse, green-grey background with clutter patches."""
    rng = np.random.default_rng(seed)
    h, w = 160, 200
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    img[..., 1] = 0.45 + 0.2 * (xx / w)
    img[..., 2] = 0.35 + 0.1 * (yy / h)
    for _ in range(40):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(4, 12)
        g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        img[..., 1] += 0.25 * rng.uniform(-1, 1) * g
        img[..., 2] += 0.25 * rng.uniform(-1, 1) * g
    img += 0.03 * rng.normal(size=(h, w, 3))
    gt = (((yy - h * 0.52) / (0.30 * h)) ** 2 +
          ((xx - w * 0.5) / (0.18 * w)) ** 2) < 1.0
    tex = 0.55 + 0.25 * np.sin(xx / 3.0) * np.sin(yy / 4.0)
    img[..., 0] = np.where(gt, tex, 0.1 + 0.05 * rng.normal(size=(h, w)))
    img[..., 1] = np.where(gt, 0.25 + 0.1 * np.cos(xx / 5.0), img[..., 1])
    img[..., 2] = np.where(gt, 0.2, img[..., 2])
    return np.clip(img, 0, 1).astype(np.float32), gt


@pytest.mark.parametrize("case,kw", [
    ("bright gray", dict(hl=0.1, hr=0.1, vl=0.1, vr=0.1)),
    ("bright gray, default margins", {}),
    ("textured rgb", dict(hl=0.1, hr=0.1, vl=0.12, vr=0.1)),
    ("textured rgb, 3 clusters, 1 round", dict(n_clusters=3,
                                               smooth_rounds=1)),
])
def test_segment_foreground_matches_jax(case, kw):
    img = (_bright_object(0) if case.startswith("bright")
           else _textured_clutter(2)[0])
    got = tseg.segment_foreground(torch.as_tensor(img), **kw).numpy()
    want = np.asarray(jseg.segment_foreground(jnp.asarray(img), **kw))
    assert got.dtype == bool and got.shape == img.shape[:2]
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    if case.startswith("textured rgb") and "vl" in kw:
        gt = _textured_clutter(2)[1]
        assert (got & gt).sum() / (got | gt).sum() >= 0.85     # IoU


@pytest.fixture(scope="module")
def scene():
    sc = j_make_scene(n_frames=6, width=96, height=72, bumps=0.0,
                      n_lat=32, n_lon=48)
    far = np.array([[50.0, 50.0, 50.0], [50.2, 50, 50], [50, 50.2, 50]],
                   np.float32)
    v = np.concatenate([sc.vertices, far]).astype(np.float32)
    n = len(sc.vertices)
    f = np.concatenate([sc.faces, [[n, n + 1, n + 2]]]).astype(np.int32)
    return sc, v, f


@pytest.mark.parametrize("with_normals", [False, True])
def test_trim_mesh_by_all_cameras_matches_jax(scene, with_normals):
    sc, v, f = scene
    c = sc.cams
    K, R, t = np.asarray(c.K), np.asarray(c.R), np.asarray(c.t)
    nrm = (np.random.default_rng(1).normal(size=v.shape).astype(np.float32)
           if with_normals else None)
    s, Rg = np.float32(1.1), np.asarray(
        [[0.9689124, 0.0, 0.24740396], [0.0, 1.0, 0.0],
         [-0.24740396, 0.0, 0.9689124]], np.float32)
    tg = np.asarray([0.35, 0.1, 0.0], np.float32)   # partly out of view
    jT = [JSim(jnp.float32(1.0), jnp.eye(3), jnp.zeros(3)),
          JSim(jnp.float32(s), jnp.asarray(Rg), jnp.asarray(tg))]
    tT = [similarity_from_numpy(1.0, np.eye(3), np.zeros(3), "cpu"),
          similarity_from_numpy(s, Rg, tg, "cpu")]
    jcams = [c[:3], c[3:]]
    tcams = [cameras_from_numpy(K[:3], R[:3], t[:3], c.width, c.height,
                                "cpu"),
             cameras_from_numpy(K[3:], R[3:], t[3:], c.width, c.height,
                                "cpu")]
    jv, jf, jn = jseg.trim_mesh_by_all_cameras(v, f, nrm, jT, jcams)
    tv, tf, tn = tseg.trim_mesh_by_all_cameras(v, f, nrm, tT, tcams)
    print(f"AllSeqProj: {len(v)} -> {len(tv)} verts, {len(tf)} faces")
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tf.dtype == np.int32
    assert 0.2 * len(v) < len(tv) < len(v) - 100   # far cluster and more
    if with_normals:
        np.testing.assert_array_equal(tn, jn)
    else:
        assert tn is None


def test_segment_masks_the_features_in_prep():
    """``segment``: prep detects on frames zeroed where the disparity is
    out of range, and keeps the raw frames for the SSD filter."""
    from multiviewstitch_tpu_torch.cli import build_demo_sequences, demo_config
    from multiviewstitch_tpu_torch.pipeline.match_edges import prep_sequence
    seqs, *_ = build_demo_sequences("cpu", n_frames=2, width=96, height=72)
    seq = seqs[0]
    noisy = type(seq)(seq.gray + 40.0 * (seq.disparity <= 0), seq.disparity,
                      seq.cams)
    cfg = demo_config()
    raw = prep_sequence(noisy, cfg)
    seg = prep_sequence(noisy, cfg.replace(segment=True))
    clean = prep_sequence(type(seq)(torch.where(
        seq.disparity > 0, noisy.gray, torch.zeros_like(noisy.gray)),
        seq.disparity, seq.cams), cfg)
    assert torch.equal(seg.gray, noisy.gray)
    assert torch.equal(seg.kp_uv, clean.kp_uv)
    assert torch.equal(seg.desc, clean.desc)
    assert not torch.equal(raw.kp_uv, seg.kp_uv)
