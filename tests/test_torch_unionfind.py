"""The largest-component trim: exact components on meshes whose vertex ids
are permuted at random (where the JAX package's 64 rounds of label
propagation stop short), equal to scipy's connected_components; and on
inputs where the JAX labels converge, the same trim as the JAX package."""

import numpy as np
import pytest
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from multiviewstitch_tpu.solvers import unionfind as juf
from multiviewstitch_tpu_torch.solvers import unionfind as uf


def permuted_grid(nx, ny, seed=0):
    """An nx x ny grid of vertices in two triangles a cell, vertex ids
    permuted at random (one connected component)."""
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    a = i * ny + j
    b, c = a + 1, a + ny
    d = c + 1
    faces = np.concatenate([np.stack([a, c, d], -1).reshape(-1, 3),
                            np.stack([a, d, b], -1).reshape(-1, 3)])
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(nx * ny, 3)).astype(np.float32)
    return verts, rng.permutation(nx * ny)[faces].astype(np.int32)


def _scipy_components(n, faces):
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    g = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    return connected_components(g, directed=False)


@pytest.mark.parametrize("nx,ny", [(300, 300), (20000, 3)])
def test_permuted_meshes_are_one_component(nx, ny):
    v, f = permuted_grid(nx, ny)
    n_comp, _ = _scipy_components(len(v), f)
    assert n_comp == 1
    kv, kf, _ = uf.retain_largest_component(v, f)
    assert len(kv) == len(v) and len(kf) == len(f)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    assert len(np.unique(uf._components(len(v), e))) == 1


def test_components_equal_scipy_and_label_by_smallest_id():
    rng = np.random.default_rng(1)
    parts = [permuted_grid(n, 4, seed=s) for s, n in enumerate((30, 50, 50))]
    offs = np.cumsum([0] + [len(p[0]) for p in parts])
    v = np.concatenate([p[0] for p in parts])
    f = np.concatenate([p[1] + o for p, o in zip(parts, offs)])
    perm = rng.permutation(len(v))
    f = perm[f]
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    labels = uf._components(len(v), e)
    n_comp, comp = _scipy_components(len(v), f)
    assert n_comp == 3 and len(np.unique(labels)) == 3
    for c in range(n_comp):
        members = np.flatnonzero(comp == c)
        assert (labels[members] == members.min()).all()
    # the two 200-vertex components tie: the one holding the smaller
    # vertex id wins, as with the converged JAX labels
    kv, kf, _ = uf.retain_largest_component(v, f)
    big = [c for c in range(3) if (comp == c).sum() == 200]
    win = min(big, key=lambda c: np.flatnonzero(comp == c).min())
    np.testing.assert_array_equal(kv, v[comp == win])


def test_trim_equals_jax_where_jax_converges():
    """A mesh of two pieces in id order (the JAX propagation converges):
    the same faces and vertices."""
    v1, f1 = permuted_grid(12, 10)
    v2, f2 = permuted_grid(6, 5, seed=2)
    v = np.concatenate([v1, v2])
    f = np.concatenate([np.sort(f1, 1), np.sort(f2, 1) + len(v1)])
    for got, want in zip(uf.retain_largest_component(v, f)[:2],
                         juf.retain_largest_component(v, f)[:2]):
        np.testing.assert_array_equal(got, want)


def test_largest_point_component_is_exact():
    rng = np.random.default_rng(3)
    chain = np.cumsum(np.full((400, 3), 0.01), 0)[rng.permutation(400)]
    blob = rng.normal(size=(100, 3)) * 0.01 + 10.0
    pts = np.concatenate([chain, blob]).astype(np.float32)
    keep = uf.largest_point_component(pts, radius=0.02)
    assert keep[:400].all() and not keep[400:].any()
