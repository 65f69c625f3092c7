"""The port's ops/mesh_normals against the JAX package's on the same numpy
meshes. Tolerance: facet normals within 1e-6 and vertex normals within 1e-5
(the scatter-adds sum in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiviewstitch_tpu.models.template_body import make_template
from multiviewstitch_tpu.ops.mesh_normals import (facet_normals as j_facet,
                                                  vertex_normals as j_vertex)
from multiviewstitch_tpu.pipeline.fixtures import uv_sphere
from multiviewstitch_tpu_torch.ops.mesh_normals import (facet_normals,
                                                        vertex_normals)

torch.set_num_threads(2)


def _mesh(name, seed=0):
    if name == "template":
        v, f, _ = make_template()
    else:
        v, f = uv_sphere(12, 16, bumps=0.1)
        rng = np.random.default_rng(seed)
        v = (v + 0.01 * rng.normal(size=v.shape)).astype(np.float32)
    return v, f


@pytest.mark.parametrize("name", ["template", "noisy sphere"])
def test_facet_normals_match_jax(name):
    v, f = _mesh(name)
    for norm in (True, False):
        want = np.asarray(j_facet(jnp.asarray(v), jnp.asarray(f), norm))
        got = facet_normals(torch.as_tensor(v), torch.as_tensor(f), norm)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["template", "noisy sphere"])
def test_vertex_normals_match_jax(name):
    v, f = _mesh(name)
    want = np.asarray(j_vertex(jnp.asarray(v), jnp.asarray(f)))
    got = vertex_normals(torch.as_tensor(v), torch.as_tensor(f))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-5)


def test_vertex_normals_face_mask_and_padding_match_jax():
    """Padded faces (masked rows, ids past num_vertices) as the JAX
    scatter's mode="drop" treats them; the padding vertex gets no
    normal."""
    v, f = _mesh("noisy sphere", seed=1)
    rng = np.random.default_rng(2)
    mask = rng.random(len(f)) > 0.8
    vp = np.concatenate([v, np.zeros((1, 3), np.float32)])
    fp = np.concatenate([f, np.full((5, 3), len(v), np.int32)])
    mp = np.concatenate([mask, np.ones(5, bool)])
    want = np.asarray(j_vertex(jnp.asarray(vp), jnp.asarray(fp),
                               jnp.asarray(mp), num_vertices=len(v)))
    got = vertex_normals(torch.as_tensor(vp), torch.as_tensor(fp),
                         torch.as_tensor(mp), num_vertices=len(v))
    assert got.shape == (len(v), 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    lone = np.setdiff1d(np.arange(len(v)), f[mask].ravel())
    assert len(lone) and np.all(got.numpy()[lone] == 0)


def test_fit_normals_drop_zero_area_slivers():
    """The template has two zero-area faces: under one-ulp noise their unit
    normals turn by rounding, and the fit's vertex normals, which leave
    them out, do not."""
    from multiviewstitch_tpu_torch.solvers.deformation import fit_normals
    from test_torch_deformation import _ulp_noise
    v, f = _mesh("template")
    ft = torch.as_tensor(f, dtype=torch.int64)
    fn = facet_normals(torch.as_tensor(v), ft, normalize=False)
    assert int((torch.linalg.norm(fn, dim=1) == 0).sum()) == 2
    vn = torch.as_tensor(_ulp_noise(v, 0))
    plain = (vertex_normals(vn, ft) - vertex_normals(torch.as_tensor(v), ft))
    fit = fit_normals(vn, ft) - fit_normals(torch.as_tensor(v), ft)
    assert plain.abs().max() > 0.1 and fit.abs().max() < 1e-4
