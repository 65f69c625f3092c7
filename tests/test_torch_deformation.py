"""The port's solvers/deformation against the JAX package's on the same
numpy inputs from a seed. Tolerance: control sets, k-NN graphs, edges and
cotangent weights equal (the same host code); fit_rotation within 1e-5;
find_correspondences' accept masks equal and targets within 1e-5;
smoothing within 1e-6; arap_solve within 1e-4 on the dense (Cholesky) and
the CG path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiviewstitch_tpu.pipeline.fixtures import uv_sphere
from multiviewstitch_tpu.solvers import deformation as JD
from multiviewstitch_tpu_torch.solvers import deformation as TD
from test_deformation import _svd_oracle

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sphere():
    return uv_sphere(20, 28, radius=1.0)


def _ulp_noise(v, seed):
    """Each coordinate moved by one float32 ulp, up or down at random."""
    up = np.random.default_rng(seed).random(v.shape) < 0.5
    return np.where(up, np.nextafter(v, np.float32(np.inf)),
                    np.nextafter(v, np.float32(-np.inf))).astype(np.float32)


def test_host_graph_construction_equals_jax(sphere):
    """The control set and k-NN graph equal the JAX package's where no two
    neighbour distances are tied (the sphere with each vertex moved by up
    to ~3 mm, seeded); edges and weights on the exact sphere."""
    v, f = sphere
    vj = (v + np.random.default_rng(0).normal(scale=1e-3, size=v.shape)
          ).astype(np.float32)
    assert np.array_equal(TD.uniform_sampling(vj), JD.uniform_sampling(vj))
    for a, b in zip(TD.knn_graph(vj[:200], 8), JD.knn_graph(vj[:200], 8)):
        assert np.array_equal(a, b)
    e = TD.mesh_edges(f)
    assert np.array_equal(e, JD.mesh_edges(f))
    assert np.array_equal(TD.cotangent_weights(v, f, e),
                          JD.cotangent_weights(v, f, e))


@pytest.mark.parametrize("seed", range(3))
def test_control_set_is_stable_under_one_ulp_noise(sphere, seed):
    """The exact sphere's rings tie many neighbour distances: the port's
    control set and k-NN graph stay the same when every coordinate moves
    by one ulp, and tied neighbours come in index order."""
    v, _ = sphere
    vn = _ulp_noise(v, seed)
    assert np.array_equal(TD.uniform_sampling(vn), TD.uniform_sampling(v))
    assert np.array_equal(TD.knn_graph(vn, 8)[0], TD.knn_graph(v, 8)[0])
    knn = TD.stable_knn(v, 17)
    d = np.linalg.norm(v[knn] - v[:, None], axis=-1)
    tied = np.abs(np.diff(d, axis=1)) <= TD.TIE_REL * np.abs(v).max()
    assert tied.any() and (np.diff(knn, axis=1)[tied] > 0).all()


def _covariances(kind, rng):
    if kind == "random":
        q1, _ = np.linalg.qr(rng.normal(size=(128, 3, 3)))
        q2, _ = np.linalg.qr(rng.normal(size=(128, 3, 3)))
        s = rng.uniform(0.01, 2.0, size=(128, 3))
        return np.einsum("nij,nj,nkj->nik", q1, s, q2).astype(np.float32)
    if kind == "rank-2":
        ang = np.pi / 2
        R = np.array([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
        g = rng.normal(size=(16, 8, 3)).astype(np.float32)
        g[..., 2] = 0.0
        return np.einsum("bni,bnj->bij", g, g @ R.T)
    if kind == "reflective":
        U, _, Vt = np.linalg.svd(rng.normal(size=(32, 3, 3)))
        return np.einsum("nij,j,njk->nik", U, np.array([3.0, 1.0, -0.5]),
                         Vt).astype(np.float32)
    if kind == "half turn":
        g = rng.normal(size=(4, 8, 3)).astype(np.float32)
        return np.einsum("bni,bnj->bij", g,
                         g @ np.diag([1.0, -1.0, -1.0]).astype(np.float32))
    return np.zeros((2, 3, 3), np.float32)


@pytest.mark.parametrize("kind", ["random", "rank-2", "reflective",
                                  "half turn", "zero"])
def test_fit_rotation_matches_jax(kind):
    S = _covariances(kind, np.random.default_rng(7))
    want = np.asarray(JD.fit_rotation(jnp.asarray(S)))
    got = TD.fit_rotation(torch.as_tensor(S)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if kind != "zero":
        np.testing.assert_allclose(got, _svd_oracle(S), atol=5e-4)


def _scan_case(seed, n_controls=60, n_scan=600):
    rng = np.random.default_rng(seed)
    sv, _ = uv_sphere(24, 32, radius=1.0)
    sv = sv[rng.choice(len(sv), n_scan, replace=False)]
    scan = (sv * np.array([1.1, 0.95, 1.0])).astype(np.float32)
    snrm = sv / np.linalg.norm(sv, axis=1, keepdims=True)
    snrm = np.where(rng.random((n_scan, 1)) < 0.1, -snrm, snrm)
    c = rng.normal(size=(n_controls, 3))
    c = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32)
    cn = (c + 0.2 * rng.normal(size=c.shape)).astype(np.float32)
    return c, cn, scan, snrm.astype(np.float32)


@pytest.mark.parametrize("seed,errs", [(0, (100.0, 100.0)), (1, (0.05, 0.1)),
                                       (2, (0.5, 0.02))])
def test_find_correspondences_matches_jax(seed, errs):
    c, cn, scan, snrm = _scan_case(seed)
    kw = dict(proj_len_err=errs[0], proj_dist_err=errs[1])
    want = JD.find_correspondences(jnp.asarray(c), jnp.asarray(cn),
                                   jnp.asarray(scan), jnp.asarray(snrm), **kw)
    got = TD.find_correspondences(torch.as_tensor(c), torch.as_tensor(cn),
                                  torch.as_tensor(scan),
                                  torch.as_tensor(snrm), **kw)
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.targets.numpy(), np.asarray(want.targets),
                               atol=1e-5, rtol=0)
    assert 0 < int(got.valid.sum()) < len(c) or seed == 0


def test_smooth_displacements_matches_jax():
    rng = np.random.default_rng(4)
    c0 = rng.normal(size=(40, 3)).astype(np.float32)
    moved = (c0 + 0.1 * rng.normal(size=c0.shape)).astype(np.float32)
    nbr, w = JD.knn_graph(c0, 8)
    want = np.asarray(JD.smooth_displacements(
        jnp.asarray(moved), jnp.asarray(c0), jnp.asarray(nbr),
        jnp.asarray(w)))
    got = TD.smooth_displacements(torch.as_tensor(moved),
                                  torch.as_tensor(c0), torch.as_tensor(nbr),
                                  torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("motion", ["noise", "rigid"])
def test_arap_solve_matches_jax(sphere, dense, motion):
    v, f = sphere
    edges = JD.mesh_edges(f)
    w = JD.cotangent_weights(v, f, edges)
    rng = np.random.default_rng(3)
    sidx = JD.uniform_sampling(v)
    constrained = np.zeros(len(v), bool)
    constrained[sidx] = True
    targets = v.copy()
    if motion == "noise":
        targets[sidx] += (0.03 * rng.normal(size=(len(sidx), 3))).astype(
            np.float32)
    else:
        ang = np.radians(30)
        R = np.array([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
        targets = (v @ R.T + np.array([0.3, -0.2, 0.5])).astype(np.float32)
    jp = JD.ARAPProblem(jnp.asarray(v), jnp.asarray(edges), jnp.asarray(w),
                        jnp.asarray(constrained), jnp.asarray(targets))
    tp = TD.ARAPProblem(torch.as_tensor(v),
                        torch.as_tensor(edges.astype(np.int64)),
                        torch.as_tensor(w), torch.as_tensor(constrained),
                        torch.as_tensor(targets))
    want = np.asarray(JD.arap_solve(jp, outer_iters=3, dense=dense))
    got = TD.arap_solve(tp, outer_iters=3, dense=dense).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(got - v).max() > 0.01


def test_cg_freezes_once_converged():
    """The CG of the sparse path keeps the state of its early exit: with a
    tolerance it meets within 100 iterations, 100 and 400 iterations agree
    exactly."""
    n = 50
    i = torch.arange(n - 1)
    w = torch.ones(n - 1)
    free = torch.ones(n, dtype=torch.bool)
    free[0] = free[-1] = False

    def mv(x):
        y = TD._laplacian_matvec(torch.where(free[:, None], x, 0.0), i,
                                 i + 1, w)
        return torch.where(free[:, None], y, 0.0)
    b = torch.where(free[:, None], torch.randn(n, 3,
                                               generator=torch.Generator()
                                               .manual_seed(0)), 0.0)
    x0 = torch.zeros(n, 3)
    pre = lambda r: r / 2.0                                     # noqa: E731
    a = TD._cg(mv, b, x0, 100, 1e-3, pre)
    c = TD._cg(mv, b, x0, 400, 1e-3, pre)
    assert torch.equal(a, c)
    assert float(torch.linalg.norm(mv(a) - b)) <= 1e-3
