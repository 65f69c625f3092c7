"""K3's plain version (the port's CPU rasterizer) against the JAX package's
render_disparity(impl="xla"), the brute-force _oracle_raster and the
Pallas raster_faces kernel in interpret mode.

Tolerances: where both hit, disparities match to rtol 1e-6 (the same
edge-function and interpolation operand order in float32); coverage may
differ only on exact-edge pixels (e == 0 under another rounding order),
at most 0.1 % of the hit pixels. raster_strips is not a reference: its
strip ids come from the unclipped bbox, so border-clipped faces render
nothing there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiviewstitch_tpu.core.cameras import CameraBatch as JCams
from multiviewstitch_tpu.ops.pallas_raster import raster_faces
from multiviewstitch_tpu.ops.rasterizer import render_disparity as j_render
from multiviewstitch_tpu_torch.core.cameras import CameraBatch
from multiviewstitch_tpu_torch.ops import rasterizer as tr
from multiviewstitch_tpu_torch.pipeline.fixtures import (uv_sphere,
                                                         ring_cameras,
                                                         make_scene)
from test_rasterizer_meshing import _oracle_raster

torch.set_num_threads(2)


def _frontal(w, h, f):
    K = np.asarray([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]],
                   np.float32)
    return K, np.eye(3, dtype=np.float32), np.zeros(3, np.float32)


def _render_both(verts, faces, K, R, t, w, h):
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    mask = np.ones(len(faces), bool)
    jd = np.asarray(j_render(jnp.asarray(verts), jnp.asarray(faces),
                             jnp.asarray(mask), JCams(K, R, t, w, h),
                             height=h, width=w, impl="xla").disparity)
    cam = CameraBatch(torch.as_tensor(K), torch.as_tensor(R),
                      torch.as_tensor(t), w, h)
    out = tr.render_disparity(torch.as_tensor(verts), torch.as_tensor(faces),
                              torch.as_tensor(mask), cam, height=h, width=w)
    assert int(out.overflow) == 0
    return out.disparity.numpy(), jd


def _assert_close(got, ref, rtol=1e-6):
    hit_g, hit_r = got > 0, ref > 0
    n_diff = int((hit_g != hit_r).sum())
    print(f"coverage differs on {n_diff} of {int(hit_r.sum())} hit pixels")
    assert n_diff <= max(0.001 * hit_r.sum(), 0)
    both = hit_g & hit_r
    np.testing.assert_allclose(got[both], ref[both], rtol=rtol, atol=0)


# The oracle projects as x/z*f and divides the weighted sum by the area once
# (not each weight), so its float32 values sit a few ulps from the
# rasterizer's; the JAX render shares the rasterizer's operand order.
ORACLE_RTOL = 1e-5


def _quad(z, s):
    return np.asarray([[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]],
                      np.float32)


CASES = {
    "plane": (_quad(2.0, 5.0), [[0, 1, 2], [0, 2, 3]], 64, 48, 60.0),
    "occlusion": (np.concatenate([_quad(2.0, 5.0), _quad(1.0, 0.2)]),
                  [[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], 64, 48, 60.0),
    "giant_closeup": (np.concatenate([_quad(2.0, 20.0), np.asarray(
        [[-30, -30, 4.0], [30, -30, 4.0], [30, 30, 4.0]], np.float32)]),
        [[0, 1, 2], [0, 2, 3], [4, 5, 6]], 320, 240, 300.0),
    "border_clipped": (np.asarray(
        [[-1.5, -1.2, 2.0], [0.3, -1.0, 2.2], [-1.2, 0.4, 1.8],
         [0.5, 0.3, 2.5], [0.9, 0.9, 2.5], [0.2, 0.8, 2.4]], np.float32),
        [[0, 1, 2], [3, 4, 5]], 64, 48, 60.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_xla_and_oracle(name):
    verts, faces, w, h, f = CASES[name]
    K, R, t = _frontal(w, h, f)
    got, jd = _render_both(verts, faces, K, R, t, w, h)
    assert (got > 0).any()
    _assert_close(got, jd)
    oracle = _oracle_raster(verts, np.asarray(faces), h, w, f, f,
                            (w - 1) / 2, (h - 1) / 2)
    _assert_close(got, oracle, ORACLE_RTOL)
    if name == "border_clipped":
        assert got[0, 0] > 0            # the clipped face reaches (0, 0)
    if name == "giant_closeup":
        np.testing.assert_allclose(got, 0.5, atol=1e-5)


def test_sphere_64x96_matches_jax_and_oracle():
    verts, faces = uv_sphere(64, 96, bumps=0.15)
    verts = verts + np.asarray([0.0, 0.0, 2.0], np.float32)
    w, h, f = 128, 96, 120.0
    K, R, t = _frontal(w, h, f)
    got, jd = _render_both(verts, faces, K, R, t, w, h)
    assert (got > 0).mean() > 0.05
    _assert_close(got, jd)
    _assert_close(got, _oracle_raster(verts, faces, h, w, f, f,
                                      (w - 1) / 2, (h - 1) / 2), ORACLE_RTOL)


def test_closeup_ring_giant_faces_match_jax_and_oracle():
    """The grazing close-up ring: a sphere of radius 0.8 at z = 2.5 seen by
    6 cameras on a 90-degree arc of radius 2.5, aimed at the origin, with
    the arc centred on the sphere. The middle cameras sit inside it, and
    its wall crosses their image planes at grazing angles: faces whose
    clipped bbox exceeds the JAX ladder's tile_large (128 px) and fall to
    its full-frame pass. (With 8 cameras, two of them see the silhouette
    edge-on from outside, where float32 interpolation differs from JAX and
    the oracle by up to 1.8e-5 relative, and JAX's tiled pass leaves a
    border-clipped face empty that the oracle renders like the port.)"""
    verts, faces = uv_sphere(32, 48, radius=0.8)
    verts[:, 2] += 2.5
    w, h, foc, n = 160, 120, 130.0, 6
    cams = ring_cameras(n, radius=2.5, width=w, img_height=h,
                        length_focal=foc, arc_deg=90.0, arc_center_deg=90.0,
                        device="cpu")
    uvz, f, ok = tr.project_vertices(torch.as_tensor(verts),
                                     torch.as_tensor(faces),
                                     torch.ones(len(faces), dtype=torch.bool),
                                     cams)
    # JAX's size measure (render_disparity): the larger clipped bbox side
    ua, va = uvz[..., 0][:, f.long()], uvz[..., 1][:, f.long()]
    bw = ua.max(-1).values.clamp(0, w - 1) - ua.min(-1).values.clamp(0, w - 1)
    bh = va.max(-1).values.clamp(0, h - 1) - va.min(-1).values.clamp(0, h - 1)
    bb = torch.where(ok, torch.maximum(bw, bh), torch.zeros_like(bw))
    assert bb.max() > 128, f"no giant face (largest {float(bb.max())})"
    got = tr.raster(uvz, f, ok, height=h, width=w).numpy()
    mask = np.ones(len(faces), bool)
    for i in range(n):
        K, R, t = (getattr(cams, a)[i].numpy() for a in "KRt")
        jr = j_render(jnp.asarray(verts), jnp.asarray(faces),
                      jnp.asarray(mask), JCams(K, R, t, w, h), height=h,
                      width=w, impl="xla")
        assert int(jr.overflow) == 0
        _assert_close(got[i], np.asarray(jr.disparity))
        pc = (verts @ R.T + t).astype(np.float32)      # camera frame
        oracle = _oracle_raster(pc, faces[ok[i].numpy()], h, w, foc, foc,
                                (w - 1) / 2, (h - 1) / 2)
        _assert_close(got[i], oracle, ORACLE_RTOL)
    assert (got > 0).mean() > 0.25


def test_matches_pallas_raster_faces_on_handled_faces():
    verts, faces = uv_sphere(24, 32, bumps=0.1)
    cams = ring_cameras(2, width=64, img_height=48, arc_deg=40.0,
                        device="cpu")
    vt, ft = torch.as_tensor(verts), torch.as_tensor(faces)
    uvz, f, ok = tr.project_vertices(vt, ft, torch.ones(len(faces),
                                                        dtype=torch.bool),
                                     cams)
    for i in range(2):
        img, handled = raster_faces(jnp.asarray(uvz[i].numpy()),
                                    jnp.asarray(f.numpy()),
                                    jnp.asarray(ok[i].numpy()), h=48, w=64,
                                    interpret=True)
        handled = torch.as_tensor(np.array(handled))
        assert handled.sum() > 0.3 * ok[i].sum()
        got = tr.raster(uvz[i:i + 1], f, handled[None], height=48,
                        width=64)[0].numpy()
        _assert_close(got, np.asarray(img))


def test_render_sequence_batches_frames_like_single_renders():
    sc = make_scene(n_frames=3, width=64, height=48, n_lat=24, n_lon=32,
                    device="cpu")
    verts = torch.as_tensor(sc.vertices)
    faces = torch.as_tensor(sc.faces)
    for i in range(3):
        one = tr.render_disparity(verts, faces,
                                  torch.ones(len(faces), dtype=torch.bool),
                                  sc.cams[i], height=48, width=64)
        assert torch.equal(one.disparity, sc.disparity[i])
    assert (sc.disparity > 0).float().mean() > 0.05
