"""Pose-graph refinement: the port's solvers/pose_graph against the JAX
package's on the same numpy match blocks (three sequences, consecutive and
skip edges), and ports of tests/test_pose_graph.py's cases.

Tolerances: the closed-form Jacobian of the Huber-weighted stacked
residual within 1e-5 of JAX's jax.jacfwd of it (and of torch.func.jacfwd
of the port's residual, the weight detached); refine_pose_graph from the same
init and data within 1e-4 (s, R, t and the RMSE)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiviewstitch_tpu.core.transforms import Similarity as JSim
from multiviewstitch_tpu.solvers import pose_graph as jpg
from multiviewstitch_tpu_torch.core.transforms import (Similarity,
                                                       apply_points, inverse)
from multiviewstitch_tpu_torch.interop import similarity_from_numpy
from multiviewstitch_tpu_torch.solvers import pose_graph as pg
from multiviewstitch_tpu_torch.solvers.ba import rodrigues

torch.set_num_threads(2)


def rand_sim(seed, s=1.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return similarity_from_numpy(s, Q, rng.normal(size=3) * 0.2, "cpu")


def make_graph(n_seqs=3, matches_per_pair=80, noise=0.0, seed=0):
    """GT transforms T_k (last = identity); match blocks for consecutive
    and skip pairs so the graph is over-determined."""
    rng = np.random.default_rng(seed)
    gt = [rand_sim(10 + k, s=1.0 + 0.15 * k) for k in range(n_seqs - 1)]
    gt.append(Similarity.identity(device="cpu"))
    world = torch.as_tensor(rng.normal(size=(400, 3)).astype(np.float32))
    pairs = []
    edges = [(k, k + 1) for k in range(n_seqs - 1)] + \
            [(k, k + 2) for k in range(n_seqs - 2)]
    for k, l in edges:
        w = world[rng.choice(400, matches_per_pair, replace=False)]
        p = apply_points(inverse(gt[k]), w).numpy()
        q = apply_points(inverse(gt[l]), w).numpy()
        if noise:
            q = q + rng.normal(size=q.shape).astype(np.float32) * noise
        pairs.append((k, l, p, q, np.ones(matches_per_pair, bool)))
    return gt, pairs


def perturb(T: Similarity, seed, mag=0.05):
    rng = np.random.default_rng(seed)
    Rp = rodrigues(torch.as_tensor(rng.normal(size=3) * mag,
                                   dtype=torch.float32))
    return Similarity(torch.tensor(float(T.s) * (1 + mag * rng.normal()),
                                   dtype=torch.float32),
                      Rp @ T.R,
                      T.t + torch.as_tensor(rng.normal(size=3) * mag,
                                            dtype=torch.float32))


def _jsim(T):
    return JSim(jnp.asarray(T.s.numpy()), jnp.asarray(T.R.numpy()),
                jnp.asarray(T.t.numpy()))


@pytest.fixture(scope="module")
def graph():
    gt, pairs = make_graph(noise=0.001)
    init = [perturb(T, 50 + i) for i, T in enumerate(gt[:-1])] + [gt[-1]]
    return gt, pairs, init


def test_build_data_equals_jax(graph):
    _, pairs, _ = graph
    got = pg.build_data(pairs, max_matches=128, device="cpu")
    want = jpg.build_data(pairs, max_matches=128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_jacobian_matches_jax_jacfwd(graph):
    """The GN Jacobian at a perturbed init, with the Huber weights on (the
    weight carries no derivative in either)."""
    _, pairs, init = graph
    data_t = pg.build_data(pairs, max_matches=128, device="cpu")
    data_j = jpg.build_data(pairs, max_matches=128)
    params = pg._log_params(init)
    delta = 0.05
    Jt = pg._jacobian(torch.as_tensor(params), data_t, torch.tensor(delta))
    Jj = jax.jacfwd(lambda x: jpg._residuals(
        x.reshape(3, 7), data_j, jnp.float32(delta)))(jnp.asarray(
            params.reshape(-1)))
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=0,
                               atol=1e-5)
    assert float(np.abs(np.asarray(Jj)).max()) > 0.1

    def weighted(x):
        r = pg._residuals(x.reshape(3, 7), data_t).reshape(-1, 128, 3)
        w = pg._weights(r.detach(), data_t, torch.tensor(delta))
        return (r * w[..., None]).reshape(-1)
    Jf = torch.func.jacfwd(weighted)(torch.as_tensor(params.reshape(-1)))
    np.testing.assert_allclose(Jt.numpy(), Jf.numpy(), rtol=0, atol=1e-5)


def test_refine_pose_graph_matches_jax(graph):
    _, pairs, init = graph
    out, rmse = pg.refine_pose_graph(
        init, pg.build_data(pairs, max_matches=128, device="cpu"), iters=30)
    jout, jrmse = jpg.refine_pose_graph([_jsim(T) for T in init],
                                        jpg.build_data(pairs,
                                                       max_matches=128),
                                        iters=30)
    print(f"pose graph rmse: port {rmse:.7f}, jax {jrmse:.7f}")
    assert abs(rmse - jrmse) <= 1e-4
    for T, J in zip(out, jout):
        assert abs(float(T.s) - float(J.s)) <= 1e-4
        np.testing.assert_allclose(T.R.numpy(), np.asarray(J.R), atol=1e-4)
        np.testing.assert_allclose(T.t.numpy(), np.asarray(J.t), atol=1e-4)


def test_pose_graph_zero_residual_at_gt():
    gt, pairs = make_graph()
    data = pg.build_data(pairs, max_matches=128, device="cpu")
    _, rmse = pg.refine_pose_graph(gt, data, iters=2)
    assert rmse < 1e-4


def test_pose_graph_recovers_from_perturbation(graph):
    gt, pairs, init = graph
    out, rmse = pg.refine_pose_graph(
        init, pg.build_data(pairs, max_matches=128, device="cpu"), iters=30)
    assert rmse < 0.01
    for To, Tg in zip(out[:-1], gt[:-1]):
        np.testing.assert_allclose(float(To.s), float(Tg.s), rtol=0.02)
        dR = To.R.numpy() @ Tg.R.numpy().T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 1.0
        assert np.linalg.norm(To.t.numpy() - Tg.t.numpy()) < 0.02


def test_pose_graph_gauge_fixed():
    gt, pairs = make_graph()
    data = pg.build_data(pairs, max_matches=128, device="cpu")
    init = [perturb(T, 99 + i) for i, T in enumerate(gt[:-1])] + [gt[-1]]
    out, _ = pg.refine_pose_graph(init, data, iters=10)
    np.testing.assert_allclose(float(out[-1].s), 1.0, rtol=1e-6)
    np.testing.assert_allclose(out[-1].R.numpy(), np.eye(3), atol=1e-6)
