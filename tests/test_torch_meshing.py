"""Per-frame grid meshes (Depth2Model) and the surface-nets extensions that
Poisson needs: the port against the JAX package on the same numpy inputs.

Tolerances: grid-mesh faces and texture indices exact (the same quad tests
on the same float32 disparities), vertices atol 1e-6 (the same unprojection
in float32); surface nets with ``min_weight`` and ``cells``: counts, faces
and cells exact, vertices atol 1e-5 (as tests/test_torch_tsdf.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiviewstitch_tpu.ops import meshing as jm
from multiviewstitch_tpu.ops import tsdf as jt
from multiviewstitch_tpu.pipeline.fixtures import make_scene as j_make_scene
from multiviewstitch_tpu_torch.interop import cameras_from_numpy
from multiviewstitch_tpu_torch.ops import meshing as tm
from multiviewstitch_tpu_torch.ops import tsdf as tt

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    sc = j_make_scene(n_frames=2, width=96, height=72, bumps=0.15,
                      n_lat=48, n_lon=64)
    d = np.array(sc.disparity)
    rng = np.random.default_rng(0)
    noisy = d * (1 + 0.02 * rng.normal(size=d.shape)).astype(np.float32)
    noisy[:, 30:34, 40:44] = 0.0                     # a hole
    noisy[1, 10, 10] = 20.0                          # out of range
    c = sc.cams
    return noisy, c, cameras_from_numpy(np.asarray(c.K), np.asarray(c.R),
                                        np.asarray(c.t), c.width, c.height,
                                        "cpu")


@pytest.mark.parametrize("frame,smooth,edge", [
    (0, 0.1, 0.0), (0, 0.5, 0.0), (1, 0.5, 0.02), (1, 5.0, 4.0),
    (0, 5.0, 0.03), (1, 5.0, 0.0)])
def test_grid_mesh_matches_jax(scene, frame, smooth, edge):
    d, jcams, tcams = scene
    kw = dict(min_dsp=1e-3, max_dsp=10.0, smooth_thres=smooth,
              edge_sz_thres=edge)
    jv, jf, jx = jm.compact_mesh(jm.grid_mesh(jnp.asarray(d[frame]),
                                              jcams[frame], **kw))
    g = tm.grid_mesh(torch.as_tensor(d[frame]), tcams[frame], **kw)
    tv, tf, tx = tm.compact_mesh(g)
    print(f"grid mesh: {len(tv)} verts, {len(tf)} faces")
    assert (g.num_vertices, g.num_faces) == (len(jv), len(jf))
    assert len(tv) > 500 and len(tf) > 100
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_allclose(tv, jv, atol=1e-6, rtol=0)


def test_edge_threshold_drops_long_edges(scene):
    d, _, tcams = scene
    kw = dict(min_dsp=1e-3, max_dsp=10.0, smooth_thres=5.0)
    full = tm.grid_mesh(torch.as_tensor(d[0]), tcams[0], **kw)
    cut = tm.grid_mesh(torch.as_tensor(d[0]), tcams[0], edge_sz_thres=0.03,
                       **kw)
    assert 0 < cut.num_faces < full.num_faces
    e = cut.vertices[cut.faces]
    for a, b in ((0, 1), (1, 2), (0, 2)):
        assert ((e[:, a] - e[:, b]) ** 2).sum(-1).max() <= 0.03 ** 2


@pytest.mark.parametrize("min_weight", [0.5, 1.0])
def test_surface_nets_min_weight_and_cells_match_jax(min_weight):
    sc = j_make_scene(n_frames=4, width=64, height=48, bumps=0.12,
                      n_lat=32, n_lon=48)
    G = 32
    origin = np.asarray([-0.7, -0.7, -0.7], np.float32)
    spacing = np.float32(1.4 / (G - 1))
    jts = jt.fuse_tsdf(sc.disparity, sc.cams, jnp.asarray(origin),
                       jnp.asarray(spacing), grid=G)
    vals = np.array(jts.values)
    wts = np.array(jts.weights)
    # a rectangular slab (Poisson's Z-slab shape)
    vals, wts = vals[3:21], wts[3:21]
    jmesh = jt.surface_nets(jt.TSDF(jnp.asarray(vals), jnp.asarray(wts),
                                    jnp.asarray(origin), jnp.asarray(spacing)),
                            min_weight=min_weight)
    tmesh = tt.surface_nets(tt.TSDF(torch.as_tensor(vals),
                                    torch.as_tensor(wts),
                                    torch.as_tensor(origin), float(spacing)),
                            min_weight=min_weight)
    nv, nf = int(jmesh.num_vertices), int(jmesh.num_faces)
    print(f"surface nets, min_weight {min_weight}: {nv} vertices, {nf} faces")
    assert nv > 50 and nf > 50
    assert (len(tmesh.vertices), len(tmesh.faces)) == (nv, nf)
    np.testing.assert_array_equal(tmesh.cells.numpy(),
                                  np.asarray(jmesh.cells[:nv]))
    np.testing.assert_array_equal(tmesh.faces.numpy(),
                                  np.asarray(jmesh.faces[:nf]))
    np.testing.assert_allclose(tmesh.vertices.numpy(),
                               np.asarray(jmesh.vertices[:nv]), atol=1e-5)
    c = tmesh.cells.numpy()
    assert (c[:, 0] < 17).all() and (c >= 0).all()
