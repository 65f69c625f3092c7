"""The port's essential-matrix filter (solvers/essential.py) against the JAX
package's: given JAX's own hypothesis draws (its Gumbel top-8 of
jax.random.key), E and the new mask match JAX's within 1e-5 (E up to its
sign, which the null vector's SVD leaves open); and the port's RANSAC on
its own stream keeps the inliers and drops the outliers
(tests/test_poisson_essential.py's cases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiviewstitch_tpu.solvers import essential as je
from multiviewstitch_tpu_torch.solvers import essential as te
from multiviewstitch_tpu_torch.solvers.srt import RansacStream, stream_key

torch.set_num_threads(2)


def make_two_view(n=100, outliers=0, seed=0):
    """Two cameras with a relative pose: pixels and K as numpy float32."""
    rng = np.random.default_rng(seed)
    K = np.array([[150.0, 0, 80.0], [0, 150.0, 60.0], [0, 0, 1]])
    pts = rng.uniform(-0.5, 0.5, size=(n, 3))
    pts[:, 2] += 3.0
    ang = 0.15
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    p2 = (R @ pts.T).T + np.array([0.3, 0.05, 0.0])

    def pix(p):
        return np.stack([K[0, 0] * p[:, 0] / p[:, 2] + K[0, 2],
                         K[1, 1] * p[:, 1] / p[:, 2] + K[1, 2]], -1)
    uv1, uv2 = pix(pts), pix(p2)
    if outliers:
        uv2[:outliers] += rng.uniform(20, 60, size=(outliers, 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), K


def _both(uv1, uv2, K):
    jr = [je.rays_from_pixels(jnp.asarray(u), jnp.asarray(K))
          for u in (uv1, uv2)]
    tr = [te.rays_from_pixels(torch.as_tensor(u), torch.as_tensor(K))
          for u in (uv1, uv2)]
    return jr, tr


def test_rays_and_eight_point_match_jax():
    uv1, uv2, K = make_two_view(8)
    jr, tr = _both(uv1, uv2, K)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    E = te._eight_point(*tr)
    assert float(te._epipolar_err(E, *tr).max()) < 1e-4
    Ej = np.asarray(je._eight_point(*jr))
    sign = np.sign((E.numpy() * Ej).sum())
    np.testing.assert_allclose(E.numpy(), sign * Ej, atol=1e-5)


@pytest.mark.parametrize("score,pixel_err,n_out", [("count", 0.003, 30),
                                                   ("area", 0.3, 0)])
def test_scoring_on_jax_draws_matches_jax(score, pixel_err, n_out):
    """At pixel_err 0.3 every match is an inlier of every hypothesis, so
    the area score ties and both keep hypothesis 0; with outliers it may
    be an ill-conditioned 8x9 system whose float32 null vectors differ by
    ~1e-4 between the two SVDs, hence the clean input there."""
    n, iters = 120, 64
    uv1, uv2, K = make_two_view(n, outliers=n_out, seed=1)
    jr, tr = _both(uv1, uv2, K)
    mask = np.ones(n, bool)
    key = jax.random.key(0)
    jm, jE, jerr = je.remove_outliers_essential(
        *jr, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask), key,
        iters=iters, pixel_err=pixel_err, score=score)
    # JAX's draws: the Gumbel top-8 remove_outliers_essential takes
    g = jax.random.gumbel(key, (iters, n))
    _, idx = jax.lax.top_k(jnp.where(jnp.asarray(mask)[None], g, -jnp.inf), 8)
    tm, tE, terr = te.essential_from_indices(
        *tr, torch.as_tensor(uv1), torch.as_tensor(uv2),
        torch.as_tensor(mask), torch.as_tensor(np.array(idx, np.int64)),
        pixel_err=pixel_err, score=score)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    Ej = np.asarray(jE)
    sign = np.sign((tE.numpy() * Ej).sum())
    np.testing.assert_allclose(tE.numpy(), sign * Ej, atol=1e-5)
    np.testing.assert_allclose(float(terr), float(jerr), atol=1e-5)


def test_essential_ransac_keeps_inliers():
    n, n_out = 120, 30
    uv1, uv2, K = make_two_view(n, outliers=n_out, seed=1)
    _, tr = _both(uv1, uv2, K)
    mask, E, err = te.remove_outliers_essential(
        *tr, torch.as_tensor(uv1), torch.as_tensor(uv2),
        torch.ones(n, dtype=torch.bool),
        RansacStream(stream_key(0, 0), torch.tensor(0)), iters=64,
        pixel_err=0.003)
    m = mask.numpy()
    assert m[n_out:].mean() > 0.9
    assert m[:n_out].mean() < 0.1
    assert E.shape == (3, 3) and np.isfinite(float(err))


def test_area_scoring_runs():
    n = 60
    uv1, uv2, K = make_two_view(n, seed=2)
    _, tr = _both(uv1, uv2, K)
    mask, _, err = te.remove_outliers_essential(
        *tr, torch.as_tensor(uv1), torch.as_tensor(uv2),
        torch.ones(n, dtype=torch.bool),
        RansacStream(stream_key(1, 0), torch.tensor(0)), iters=32,
        pixel_err=0.3, score="area")
    assert int(mask.sum()) >= 2 and np.isfinite(float(err))
    with pytest.raises(ValueError, match="score"):
        te.essential_from_indices(*tr, torch.as_tensor(uv1),
                                  torch.as_tensor(uv2),
                                  torch.ones(n, dtype=torch.bool),
                                  torch.arange(8)[None], score="bogus")
