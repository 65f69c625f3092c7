"""Screened Poisson reconstruction: the port against the JAX package on the
same oriented clouds made from a seed (tests/test_poisson_multigrid.py's
unit sphere).

Tolerances:
- the stencil, the restriction and the trilinear splat / gather: equal
  to rounding (atol 1e-6 relative to the field's scale; the restriction
  is exact: pairwise means in the JAX einsums' order);
- occupancy dilation: exact;
- poisson_field at grid 32 (CG, 300 iterations) and 64 (multigrid, 12
  V-cycles): max |difference| <= 1e-5 of the field's range (the two
  libraries sum the CG dot products and the iso level in other orders);
  weight grids atol 1e-6;
- the port's slab extraction equals its whole-grid extraction exactly
  (cells and faces; positions within 1e-5);
- reconstruct_poisson at depth 5 and 6: vertex and face counts within 1 %,
  symmetric chamfer distance < 0.1 voxel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiviewstitch_tpu.ops import poisson as JP
from multiviewstitch_tpu_torch.ops import poisson as TP

torch.set_num_threads(2)


def _sphere_cloud(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), v.astype(np.float32)


def _setup(pts, grid):
    mins, maxs = pts.min(0), pts.max(0)
    span = (maxs - mins).max() * 1.2
    origin = (mins - (maxs - mins).max() * 0.1).astype(np.float32)
    return origin, np.float32(span / (grid - 1))


def _field(rng, g=32):
    return rng.normal(size=(g, g, g)).astype(np.float32)


def test_stencil_restriction_and_prolongation_match_jax():
    rng = np.random.default_rng(0)
    x = _field(rng)
    np.testing.assert_array_equal(TP._laplacian(torch.as_tensor(x)).numpy(),
                                  np.asarray(JP._laplacian(jnp.asarray(x))))
    np.testing.assert_array_equal(TP._restrict2(torch.as_tensor(x)).numpy(),
                                  np.asarray(JP._restrict2(jnp.asarray(x))))
    e = _field(rng, 16)
    got = TP._prolong_add(torch.as_tensor(x.copy()), torch.as_tensor(e))
    want = jnp.asarray(x) + JP._prolong2(jnp.asarray(e))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    b = _field(rng)
    got = TP._smooth_jacobi(torch.as_tensor(x.copy()), torch.as_tensor(b),
                            1e-3, 3)
    want = JP._smooth_jacobi(jnp.asarray(x), jnp.asarray(b), 1e-3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_splat_gather_and_blur_match_jax():
    pts, _ = _sphere_cloud(500)
    origin, spacing = _setup(pts, 32)
    gidx = (pts - origin) / spacing
    vals = np.random.default_rng(1).normal(size=len(pts)).astype(np.float32)
    got = TP._trilinear_scatter(32, torch.as_tensor(gidx),
                                torch.as_tensor(vals))
    want = JP._trilinear_scatter((32, 32, 32), jnp.asarray(gidx),
                                 jnp.asarray(vals)[:, None])[..., 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    f = _field(np.random.default_rng(2))
    np.testing.assert_allclose(
        TP._trilinear_gather(torch.as_tensor(f), torch.as_tensor(gidx)),
        np.asarray(JP._trilinear_gather(jnp.asarray(f), jnp.asarray(gidx))),
        atol=1e-6)
    blurred = TP._box_blur_(torch.as_tensor(f.copy()))
    jb = jnp.asarray(f)
    for _ in range(2):
        for ax in range(3):
            jb = (jb + jnp.roll(jb, 1, ax) + jnp.roll(jb, -1, ax)) / 3.0
    np.testing.assert_allclose(blurred.numpy(), np.asarray(jb), atol=1e-6)


@pytest.mark.parametrize("radius", [0, 1, 3])
def test_dilate_occupancy_matches_jax(radius):
    rng = np.random.default_rng(radius)
    w = np.where(rng.random((24, 24, 24)) < 0.01, 1.0, 0.0).astype(np.float32)
    w[0, 0, 0] = 1.0                      # wraps, like the JAX rolls
    got = TP._dilate_occupancy(torch.as_tensor(w), radius).numpy()
    want = np.asarray(JP._dilate_occupancy(jnp.asarray(w), radius))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == bool and got[-1, -1, -1] == (radius > 0)


@pytest.mark.parametrize("grid,solver", [(32, "cg"), (64, "multigrid"),
                                         (32, "auto")])
def test_poisson_field_matches_jax(grid, solver):
    pts, nrm = _sphere_cloud()
    origin, spacing = _setup(pts, grid)
    valid = np.ones(len(pts), bool)
    valid[::7] = False
    jf, jw = JP.poisson_field(jnp.asarray(pts), jnp.asarray(nrm),
                              jnp.asarray(valid), jnp.asarray(origin),
                              jnp.asarray(spacing), grid=grid, solver=solver)
    tf, tw = TP.poisson_field(torch.as_tensor(pts), torch.as_tensor(nrm),
                              torch.as_tensor(valid), torch.as_tensor(origin),
                              float(spacing), grid=grid, solver=solver)
    jf, jw = np.asarray(jf), np.asarray(jw)
    scale = float(jf.max() - jf.min())
    err = float(np.abs(tf.numpy() - jf).max())
    print(f"poisson_field grid {grid} {solver}: max |diff| {err:.3g} of "
          f"range {scale:.3g}")
    assert scale > 0 and err <= 1e-5 * scale
    np.testing.assert_allclose(tw.numpy(), jw, atol=1e-6)


def test_slab_extraction_matches_whole_grid():
    """Z-slab extraction (halo slabs + exact integer-cell welding + min-z
    face ownership) reproduces the port's whole-volume extraction."""
    pts, nrm = _sphere_cloud()
    origin, spacing = _setup(pts, 64)
    field, wgt = TP.poisson_field(torch.as_tensor(pts), torch.as_tensor(nrm),
                                  torch.ones(len(pts), dtype=torch.bool),
                                  torch.as_tensor(origin), float(spacing),
                                  grid=64, cg_iters=200)
    occ = TP._dilate_occupancy(wgt, 6)
    o = torch.as_tensor(origin)
    vw, fw, cw = TP._extract_mesh(field, occ, o, spacing)
    assert len(vw) > 1000
    for slab in (16, 21):
        vs, fs, cs = TP._extract_mesh_slabs(field, occ, o, spacing,
                                            slab=slab, return_cells=True)
        assert (len(vs), len(fs)) == (len(vw), len(fw))

        def soup(c, f):
            k = c.astype(np.int64)
            return {tuple(sorted(map(tuple, k[tri]))) for tri in f}
        assert soup(cw, fw) == soup(cs, fs)
        ow, os_ = np.lexsort(cw.T), np.lexsort(cs.T)
        np.testing.assert_array_equal(cw[ow], cs[os_])
        np.testing.assert_allclose(vw[ow], vs[os_], atol=1e-5)


def test_slab_extraction_keeps_a_sheet_past_the_jax_caps():
    """A z-facing sheet puts more vertices (383^2 = 146,689) and faces
    (2 * 382^2 = 291,848) into one Z-slab than the JAX package's per-slab
    capacities (131,072 / 262,144): the port's slab and whole-grid
    extractions keep all of them, one vertex per cell of the sheet's
    layer at the crossing and two faces per interior quad."""
    gz, g, z_sheet = 40, 384, 10.3
    z = torch.arange(gz, dtype=torch.float32)
    field = (z_sheet - z)[:, None, None].expand(gz, g, g).contiguous()
    occ = torch.ones(field.shape, dtype=torch.bool)
    o = torch.zeros(3)
    vw, fw, _ = TP._extract_mesh(field, occ, o, 1.0)
    vs, fs = TP._extract_mesh_slabs(field, occ, o, 1.0, slab=32)
    for v, f in ((vw, fw), (vs, fs)):
        assert len(v) == (g - 1) ** 2 > 131072
        assert len(f) == 2 * (g - 2) ** 2 > 262144
        np.testing.assert_allclose(v[:, 2], z_sheet, atol=1e-5)
        assert f.min() >= 0 and f.max() < len(v)
    assert {tuple(sorted(map(tuple, vw[t]))) for t in fw[::97]} <= \
        {tuple(sorted(map(tuple, vs[t]))) for t in fs}


def _chamfer(a, b):
    def one(p, q):
        return np.concatenate([
            np.sqrt(((p[c:c + 1024, None] - q[None]) ** 2).sum(-1).min(1))
            for c in range(0, len(p), 1024)]).mean()
    return 0.5 * (one(a, b) + one(b, a))


@pytest.mark.parametrize("depth,solver", [(5, "auto"), (6, "auto"),
                                          (5, "multigrid")])
def test_reconstruct_poisson_matches_jax(depth, solver):
    pts, nrm = _sphere_cloud()
    jv, jf = JP.reconstruct_poisson(pts, nrm, depth=depth, solver=solver,
                                    vcycles=10)
    tv, tf = TP.reconstruct_poisson(pts, nrm, depth=depth, solver=solver,
                                    vcycles=10, device="cpu")
    span = float((pts.max(0) - pts.min(0)).max())
    voxel = span * 1.2 / ((1 << depth) - 1)
    ch = _chamfer(tv, jv)
    print(f"depth {depth} {solver}: jax {len(jv)}/{len(jf)}, port "
          f"{len(tv)}/{len(tf)}, chamfer {ch / voxel:.4f} voxel")
    assert len(jv) > 300
    assert abs(len(tv) - len(jv)) <= 0.01 * len(jv)
    assert abs(len(tf) - len(jf)) <= 0.01 * len(jf)
    assert ch < 0.1 * voxel
    r = np.linalg.norm(tv, axis=1)
    assert abs(r.mean() - 1.0) < 0.01 and r.std() < 0.02
    assert tf.min() >= 0 and tf.max() < len(tv)
