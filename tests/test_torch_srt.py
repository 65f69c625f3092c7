"""SRT solver: the port against the JAX package on the same numpy inputs.

RANSAC draws threefry numbers in JAX, which torch cannot reproduce, so
the test draws JAX's hypothesis triples (the same gumbel + top_k that
estimate_srt_ransac runs) and feeds them to the port's scorer. Tolerance:
atol 1e-4 on the winning s, R, t and residual (float32 Kabsch through two
different SVD implementations)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiviewstitch_tpu.core.cameras import CameraBatch as JCams
from multiviewstitch_tpu.core.transforms import Similarity as JSim
from multiviewstitch_tpu.solvers import srt as js
from multiviewstitch_tpu_torch.interop import (cameras_from_numpy,
                                               similarity_from_numpy)
from multiviewstitch_tpu_torch.solvers import srt as ts

torch.set_num_threads(2)


def _cam(seed):
    rng = np.random.default_rng(seed)
    K = np.asarray([[120.0, 0, 63.5], [0, 120.0, 47.5], [0, 0, 1]],
                   np.float32)
    a = rng.uniform(-0.2, 0.2)
    R = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]], np.float32)
    t = np.asarray([0.0, 0.0, 2.0], np.float32)
    return K, R, t


def _problem(seed, m=96, outlier_frac=0.25):
    rng = np.random.default_rng(seed)
    p1 = (rng.normal(size=(m, 3)) * 0.3).astype(np.float32)
    ang = rng.uniform(-0.4, 0.4)
    R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                    [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    s, t = np.float32(1.3), rng.normal(size=3).astype(np.float32) * 0.1
    p2 = (s * p1 @ R.T + t + rng.normal(size=(m, 3)) * 0.002).astype(
        np.float32)
    bad = rng.random(m) < outlier_frac
    p2[bad] += rng.normal(size=(int(bad.sum()), 3)).astype(np.float32) * 0.3
    mask = rng.random(m) < 0.9
    return p1, p2, mask, (s, R, t), bad


def _jcam(K, R, t):
    return JCams(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), 128, 96)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scorer_matches_jax_on_jax_triples(seed):
    p1, p2, mask, _, _ = _problem(seed)
    c1, c2 = _cam(seed), _cam(seed + 100)
    key = jax.random.key(seed)
    iters = 64
    jT, jerr = js.estimate_srt_ransac(jnp.asarray(p1), jnp.asarray(p2),
                                      jnp.asarray(mask), _jcam(*c1),
                                      _jcam(*c2), key, iter_num=iters)
    g = jax.random.gumbel(key, (iters, p1.shape[0]))
    g = jnp.where(jnp.asarray(mask)[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, 3)
    tT, terr = ts.estimate_srt_from_triples(
        torch.as_tensor(p1), torch.as_tensor(p2), torch.as_tensor(mask),
        cameras_from_numpy(*c1, 128, 96, "cpu"),
        cameras_from_numpy(*c2, 128, 96, "cpu"),
        torch.as_tensor(np.array(idx)).long())
    np.testing.assert_allclose(float(tT.s), float(jT.s), atol=1e-4)
    np.testing.assert_allclose(tT.R.numpy(), np.asarray(jT.R), atol=1e-4)
    np.testing.assert_allclose(tT.t.numpy(), np.asarray(jT.t), atol=1e-4)
    np.testing.assert_allclose(float(terr), float(jerr), atol=1e-4)


@pytest.mark.parametrize("seed", [3, 4])
def test_scale_kabsch_and_errors_match_jax(seed):
    p1, p2, mask, (s, R, t), _ = _problem(seed)
    c1, c2 = _cam(seed), _cam(seed + 1)
    tp1, tp2, tm = map(torch.as_tensor, (p1, p2, mask))
    np.testing.assert_allclose(
        float(ts.estimate_scale(tp1, tp2, tm)),
        float(js.estimate_scale(jnp.asarray(p1), jnp.asarray(p2),
                                jnp.asarray(mask))), rtol=1e-5)
    w = mask.astype(np.float32)
    jR, jt = js.kabsch_rt(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w),
                          jnp.float32(s))
    tR, tt = ts.kabsch_rt(tp1, tp2, torch.as_tensor(w), torch.tensor(s))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    jT = JSim(jnp.float32(s), jnp.asarray(R), jnp.asarray(t))
    tT = similarity_from_numpy(s, R, t, "cpu")
    je = js.per_match_errors(jT, jnp.asarray(p1), jnp.asarray(p2),
                             _jcam(*c1), _jcam(*c2))
    te = ts.per_match_errors(tT, tp1, tp2,
                             cameras_from_numpy(*c1, 128, 96, "cpu"),
                             cameras_from_numpy(*c2, 128, 96, "cpu"))
    for a, b in zip(te, je):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(
        float(ts.residual_error(tT, tp1, tp2, tm,
                                cameras_from_numpy(*c1, 128, 96, "cpu"),
                                cameras_from_numpy(*c2, 128, 96, "cpu"))),
        float(js.residual_error(jT, jnp.asarray(p1), jnp.asarray(p2),
                                jnp.asarray(mask), _jcam(*c1), _jcam(*c2))),
        atol=1e-4)


def test_remove_outliers_drops_injected_outliers_batched():
    """Batched over an edge axis: each edge recovers its similarity and
    prunes its gross outliers, and the batch equals the per-edge runs."""
    probs = [_problem(s, m=80) for s in (5, 6)]
    p1 = torch.as_tensor(np.stack([p[0] for p in probs]))
    p2 = torch.as_tensor(np.stack([p[1] for p in probs]))
    mask = torch.as_tensor(np.stack([p[2] for p in probs]))
    cams = [_cam(7), _cam(8)]
    c1 = cameras_from_numpy(*[np.stack([cams[0][k]] * 2) for k in range(3)],
                            128, 96, "cpu")
    c2 = cameras_from_numpy(*[np.stack([cams[1][k]] * 2) for k in range(3)],
                            128, 96, "cpu")
    stream = ts.RansacStream(ts.stream_key(0, 0), torch.arange(2))
    out, T, res = ts.remove_outliers(p1, p2, mask, c1, c2, stream,
                                     pixel_err=12.0, adapt_ratio=0.6,
                                     iter_num=128, rounds=3)
    for e, (_, _, m, (s, R, _), bad) in enumerate(probs):
        assert abs(float(T.s[e]) - s) < 0.02
        assert np.abs(T.R[e].numpy() - R).max() < 0.02
        kept = out[e].numpy()
        assert not (kept & bad).any()
        assert (kept & ~bad & m).sum() > 0.8 * (~bad & m).sum()
        assert float(res[e]) < 2.0
    idx = ts.sample_triples(mask, 16, stream, 1)
    assert idx.shape == (2, 16, 3)
    picked = torch.gather(mask[:, None, :].expand(-1, 16, -1), 2, idx)
    assert picked.all()
    assert (idx[..., 0] != idx[..., 1]).all()
