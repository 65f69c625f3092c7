"""The port's solvers/pca and core/transforms.rotation_between against the
JAX package's on the same numpy inputs from a seed. Tolerance: pivots'
columns within 1e-5 with the same signs, eigenvalues within 1e-5 of the
largest; centres, extents and the plane within 1e-5; rotations within
1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiviewstitch_tpu.core.transforms import (
    rotation_between as j_rotation_between)
from multiviewstitch_tpu.solvers import pca as J
from multiviewstitch_tpu_torch.core.transforms import rotation_between
from multiviewstitch_tpu_torch.solvers import pca as T

torch.set_num_threads(2)


def _cloud(seed, n=500, batch=()):
    """Anisotropic points: the axes' spreads 2 : 1 : 0.3, randomly turned,
    so the covariance decides the eigenvectors' signs."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=batch + (3, 3)))
    p = rng.normal(size=batch + (n, 3)) * np.array([2.0, 1.0, 0.3])
    p = np.einsum("...ij,...nj->...ni", q, p) + rng.normal(size=batch + (1, 3))
    return p.astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_pivots_match_jax_with_the_same_signs(seed):
    p = _cloud(seed)
    jv, jw, jc = J.pivots(jnp.asarray(p))
    tv, tw, tc = T.pivots(torch.as_tensor(p))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    assert np.array_equal(np.sign(tv.numpy()), np.sign(np.asarray(jv)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-5 * float(jw[0]))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


@pytest.mark.parametrize("kind", ["batched", "masked"])
def test_pivots_batched_or_masked_match_jax(kind):
    """(The JAX pivots cannot take a batched mask: its count does not
    broadcast against the covariances.)"""
    if kind == "batched":
        p, mask = _cloud(7, n=300, batch=(4,)), None
    else:
        p = _cloud(7, n=300)
        mask = np.random.default_rng(8).random(300) > 0.2
    jv, jw, jc = J.pivots(jnp.asarray(p),
                          None if mask is None else jnp.asarray(mask))
    tv, tw, tc = T.pivots(torch.as_tensor(p),
                          None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    assert np.array_equal(np.sign(tv.numpy()), np.sign(np.asarray(jv)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-5 * float(np.max(jw)))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_barycenter_aabb_extent_match_jax(masked):
    p = _cloud(9)
    m = np.random.default_rng(10).random(len(p)) > 0.5 if masked else None
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.as_tensor(m)
    pj, pt = jnp.asarray(p), torch.as_tensor(p)
    np.testing.assert_allclose(T.barycenter(pt, tm).numpy(),
                               np.asarray(J.barycenter(pj, jm)), atol=1e-5)
    for a, b in zip(T.aabb(pt, tm), J.aabb(pj, jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    axis = np.array([0.3, -0.8, 0.5], np.float32)
    c = p.mean(0)
    got = T.extent_along(pt, torch.as_tensor(axis), torch.as_tensor(c), tm)
    want = J.extent_along(pj, jnp.asarray(axis), jnp.asarray(c), jm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_plane_fit_matches_jax():
    rng = np.random.default_rng(11)
    pts = np.zeros((200, 3), np.float32)
    pts[:, :2] = rng.normal(size=(200, 2))
    pts[:, 2] = 0.5 + 0.01 * rng.normal(size=200)
    pts = pts @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T.astype(np.float32)
    jn, jd = J.plane_fit(jnp.asarray(pts))
    tn, td = T.plane_fit(torch.as_tensor(pts))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    assert abs(float(td) - float(jd)) < 1e-5


@pytest.mark.parametrize("case", ["random", "parallel", "antiparallel x"])
def test_rotation_between_matches_jax(case):
    """Antiparallel pairs are taken along an axis, where a x b is exactly
    zero: off the axes both versions' cross products leave a rounding
    residue and take the generic branch about a noise axis (the alignment
    calls it with sign-matched axes, never antiparallel)."""
    rng = np.random.default_rng(12)
    a = rng.normal(size=(16, 3)).astype(np.float32)
    b = {"random": rng.normal(size=(16, 3)).astype(np.float32),
         "parallel": 2.0 * a, "antiparallel": -a}.get(case)
    if case == "antiparallel x":
        a = np.tile(np.float32([[1.0, 0.0, 0.0]]), (2, 1))
        b = -a
    got = rotation_between(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(j_rotation_between(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.einsum("nij,nkj->nik", got, got),
                               np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-5)
    an = a / np.linalg.norm(a, axis=1, keepdims=True)
    bn = b / np.linalg.norm(b, axis=1, keepdims=True)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", got, an), bn,
                               atol=1e-5)
