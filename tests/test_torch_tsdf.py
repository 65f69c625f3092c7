"""TSDF fusion and surface nets: the port against the JAX package on the
same numpy inputs at grid 32. Tolerances: TSDF values and weights atol
1e-5 (float32 projection in the same operand order; a voxel whose pixel
round-trip lands on a floor(x+0.5) tie could differ, none does here);
surface-nets vertex and face counts equal, vertices atol 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiviewstitch_tpu.core.transforms import Similarity as JSim
from multiviewstitch_tpu.ops import tsdf as jt
from multiviewstitch_tpu.pipeline.fixtures import make_scene as j_make_scene
from multiviewstitch_tpu_torch.interop import (cameras_from_numpy,
                                               similarity_from_numpy)
from multiviewstitch_tpu_torch.ops import tsdf as tt

torch.set_num_threads(2)

G = 32


@pytest.fixture(scope="module")
def scene():
    sc = j_make_scene(n_frames=4, width=64, height=48, bumps=0.12,
                      n_lat=32, n_lon=48)
    c = sc.cams
    return (np.array(sc.disparity), np.array(c.K), np.array(c.R),
            np.array(c.t), c.width, c.height, sc.cams)


def test_fuse_tsdf_and_surface_nets_match_jax(scene):
    d, K, R, t, w, h, jcams = scene
    origin = np.asarray([-0.7, -0.7, -0.7], np.float32)
    spacing = np.float32(1.4 / (G - 1))
    jts = jt.fuse_tsdf(jnp.asarray(d), jcams, jnp.asarray(origin),
                       jnp.asarray(spacing), grid=G, trunc=3.0,
                       min_dsp=1e-4, max_dsp=1e4)
    tts = tt.fuse_tsdf(torch.as_tensor(d),
                       cameras_from_numpy(K, R, t, w, h, "cpu"),
                       torch.as_tensor(origin), float(spacing), grid=G,
                       trunc=3.0, min_dsp=1e-4, max_dsp=1e4)
    np.testing.assert_allclose(tts.weights.numpy(), np.asarray(jts.weights),
                               atol=1e-5)
    np.testing.assert_allclose(tts.values.numpy(), np.asarray(jts.values),
                               atol=1e-5)
    assert (tts.weights.numpy() > 0).mean() > 0.05

    jm = jt.surface_nets(jts)
    tm = tt.surface_nets(tts)
    nv, nf = int(jm.num_vertices), int(jm.num_faces)
    print(f"surface nets: {nv} vertices, {nf} faces")
    assert nv > 100 and nf > 100
    assert (len(tm.vertices), len(tm.faces)) == (nv, nf)
    np.testing.assert_allclose(tm.vertices.numpy(),
                               np.asarray(jm.vertices[:nv]), atol=1e-5)
    np.testing.assert_array_equal(tm.faces.numpy(),
                                  np.asarray(jm.faces[:nf]))


def test_fuse_multi_sequence_matches_jax(scene):
    d, K, R, t, w, h, jcams = scene
    s, Rg = np.float32(1.2), np.eye(3, dtype=np.float32)
    tg = np.asarray([0.1, 0.0, -0.1], np.float32)
    jT = [JSim(jnp.float32(s), jnp.asarray(Rg), jnp.asarray(tg)),
          JSim(jnp.float32(1.0), jnp.eye(3), jnp.zeros(3))]
    tT = [similarity_from_numpy(s, Rg, tg, "cpu"),
          similarity_from_numpy(1.0, np.eye(3), np.zeros(3), "cpu")]
    jv, jf, _ = jt.fuse_multi_sequence([d[:2], d[2:]], [jcams[:2], jcams[2:]],
                                       jT, grid=G, min_dsp=1e-3,
                                       max_dsp=10.0)
    cams = cameras_from_numpy(K, R, t, w, h, "cpu")
    tv, tf, _ = tt.fuse_multi_sequence(
        [torch.as_tensor(d[:2]), torch.as_tensor(d[2:])], [cams[:2],
                                                           cams[2:]],
        tT, grid=G, min_dsp=1e-3, max_dsp=10.0)
    print(f"multi-sequence mesh: jax {len(jv)}/{len(jf)}, "
          f"port {len(tv)}/{len(tf)}")
    assert len(jv) > 50
    assert abs(len(tv) - len(jv)) <= 0.01 * len(jv)
    assert abs(len(tf) - len(jf)) <= 0.01 * len(jf)


def test_fuse_multi_sequence_keeps_every_vertex_past_the_jax_caps():
    """A full ring of 8 frames around the bumpy sphere at grid 160: the
    surface has more than the JAX package's 65,536 vertices, and
    fuse_multi_sequence returns all of them and every face."""
    from multiviewstitch_tpu_torch.core.transforms import Similarity
    from multiviewstitch_tpu_torch.pipeline.fixtures import make_scene
    sc = make_scene(n_frames=8, width=160, height=120, bumps=0.12,
                    arc_deg=360.0, device="cpu")
    v, f, ts = tt.fuse_multi_sequence(
        [sc.disparity], [sc.cams], [Similarity.identity(device="cpu")],
        grid=160, min_dsp=1e-3, max_dsp=10.0)
    whole = tt.surface_nets(ts)
    print(f"full ring at grid 160: {len(v)} vertices, {len(f)} faces")
    assert len(v) == len(whole.vertices) > 65536
    assert len(f) == len(whole.faces) > 131072
    assert f.min() >= 0 and f.max() == len(v) - 1
