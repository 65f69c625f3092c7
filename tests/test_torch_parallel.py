"""The port's multi-device layer (multiviewstitch_tpu_torch/parallel) at 2
and 4 gloo ranks on the CPU, against the JAX package's sharded functions on
conftest's 8-virtual-device CPU mesh and against the port's own unsharded
functions.

The ranks are spawned by ``parallel.mesh.run_spmd`` (file:// store, one
thread a rank); each rank imports torch and the port only. All the sharded
calls of one world size share one start of the ranks (``spmd_calls``).

Tolerances: the windowed consistency filter equals the global one and
JAX's windowed filter exactly (the same elementwise float32 arithmetic;
the fixture has no floor(x+0.5) ties). Sharded BA and both ARAP layouts
reduce in another order than the unsharded solvers, so they are held to
the JAX package's own tolerances (tests/test_parallel.py): BA rvec within
2e-3, tvec within 2e-2, RMSE within 0.1; ARAP within 5e-3 of the
unsharded solve and 0.03 of the true motion. BA pins cameras 0 and 5: with
one fixed camera the scale is a free direction along which each solver's
float32 rounding walks its own way."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiviewstitch_tpu.core.cameras import CameraBatch as JCams
from multiviewstitch_tpu.parallel import arap_blocks as j_blocks
from multiviewstitch_tpu.parallel import ba_dist as j_ba
from multiviewstitch_tpu.parallel.arap_dist import (
    arap_solve_sharded as j_arap_sharded)
from multiviewstitch_tpu.parallel.mesh import make_mesh as j_make_mesh
from multiviewstitch_tpu.parallel.view_windows import (
    check_consistency_windowed as j_windowed)
from multiviewstitch_tpu.pipeline.fixtures import uv_sphere as j_uv_sphere
from multiviewstitch_tpu.solvers import deformation as JD
from multiviewstitch_tpu_torch.core.cameras import CameraBatch
from multiviewstitch_tpu_torch.interop import (arap_blocks_from_numpy,
                                               ba_blocks_from_numpy,
                                               ba_state_from_numpy)
from multiviewstitch_tpu_torch.ops.consistency import check_consistency
from multiviewstitch_tpu_torch.parallel import (arap_blocks, arap_dist,
                                                ba_dist, mesh as pmesh,
                                                view_windows)
from multiviewstitch_tpu_torch.solvers import ba, deformation as TD
from tests.test_ba import synth_ba_problem

torch.set_num_threads(2)

KW = dict(min_dsp=1e-3, max_dsp=10.0, reproj_err=2)
HALOS = (1, 2)
WORLDS = (2, 4)
BA_FIXED = (0, 5)
BA_ITERS = 15
ARAP_KW = dict(outer_iters=6, cg_iters=200)


def ring_sequence(n=16, h=48, w=64, seed=0):
    """tests/test_view_windows.py's ring: a smooth disparity field, a patch
    whose depth disagrees from frame to frame, translating cameras."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.25, 0.3, size=(1, h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = base + 0.05 * np.sin(xx / 17.0)[None] * np.cos(yy / 13.0)[None]
    disp = np.broadcast_to(disp, (n, h, w)).copy()
    ph = np.linspace(0, 3.0, n, dtype=np.float32)[:, None, None]
    disp[:, h // 4:h // 2, w // 4:w // 2] *= (1.0 + 0.4 * np.sin(ph))
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 80.0
    K[:, 0, 2] = (w - 1) / 2
    K[:, 1, 2] = (h - 1) / 2
    K[:, 2, 2] = 1
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
    t = np.zeros((n, 3), np.float32)
    t[:, 0] = np.linspace(0, 12.0, n)
    return disp, K, R, t


def ba_problem():
    """JAX's synth_ba_problem in the grouped layout, as numpy: (JAX
    BAPointBlocks fields, init state)."""
    prob, _, init = synth_ba_problem(n_cams=6, n_pts=64, pose_noise=0.01,
                                     pt_noise=0.02)
    blocks = j_ba.group_by_point(
        np.asarray(prob.K), np.asarray(prob.cam_idx),
        np.asarray(prob.pt_idx), np.asarray(prob.uv), 64, 6,
        max_obs_per_point=6, fixed_cams=BA_FIXED)
    return prob, blocks, init


def arap_problem():
    """tests/test_parallel.py's ARAP problem: uv_sphere(16, 22) moved by
    25 degrees about z and a shift, its uniform-sampling controls pinned."""
    v, f = j_uv_sphere(16, 22, radius=1.0)
    edges = JD.mesh_edges(f)
    w = JD.cotangent_weights(v, f, edges)
    ang = np.radians(25)
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    moved = (R @ v.T).T + np.array([0.2, -0.1, 0.3], np.float32)
    constrained = np.zeros(len(v), bool)
    constrained[JD.uniform_sampling(v)] = True
    targets = np.where(constrained[:, None], moved, 0.0).astype(np.float32)
    return v, edges, w, constrained, targets, moved


def _t_arap(v, edges, w, constrained, targets):
    return TD.ARAPProblem(torch.as_tensor(v),
                          torch.as_tensor(np.asarray(edges, np.int64)),
                          torch.as_tensor(np.asarray(w, np.float32)),
                          torch.as_tensor(constrained),
                          torch.as_tensor(targets))


@pytest.fixture(scope="module")
def inputs():
    disp, K, R, t = ring_sequence()
    n, h, w = disp.shape
    _, jblocks, jinit = ba_problem()
    v, edges, wts, con, tgt, moved = arap_problem()
    return dict(disp=disp, K=K, R=R, t=t, w=w, h=h, jblocks=jblocks,
                jinit=jinit, arap=(v, edges, wts, con, tgt), moved=moved)


def _calls(inputs, world):
    """The sharded calls of one world size: the windowed filter at each
    halo, BA, and both ARAP layouts (inputs converted from the JAX
    package's arrays)."""
    d = torch.as_tensor(inputs["disp"])
    cams = CameraBatch(torch.as_tensor(inputs["K"]),
                       torch.as_tensor(inputs["R"]),
                       torch.as_tensor(inputs["t"]), inputs["w"],
                       inputs["h"])
    jb = inputs["jblocks"]
    blocks = ba_blocks_from_numpy(*(np.asarray(x) for x in jb), device="cpu")
    init = ba_state_from_numpy(*(np.asarray(x) for x in inputs["jinit"]),
                               device="cpu")
    v, edges, wts, con, tgt = inputs["arap"]
    ep, wp = arap_dist.pad_edges(edges, wts, world)
    jbp = j_blocks.build_blocks(v, edges, wts, con, tgt, world)
    bprob = arap_blocks_from_numpy(*(np.asarray(x) for x in jbp[:6]),
                                   jbp.n_vertices)
    calls = [(view_windows.check_consistency_sharded, (d, cams),
              dict(KW, halo=halo)) for halo in HALOS]
    calls += [(ba_dist.solve_ba_sharded, (blocks, init),
               dict(iters=BA_ITERS)),
              (arap_dist.arap_solve_sharded,
               (_t_arap(v, ep, wp, con, tgt),), ARAP_KW),
              (arap_blocks.arap_solve_blocks, (bprob,), ARAP_KW)]
    return calls


@pytest.fixture(scope="module")
def ranks(inputs):
    """{world: [per-rank results of _calls]}, one run_spmd per world."""
    return {world: pmesh.run_spmd(pmesh.spmd_calls, world,
                                  _calls(inputs, world), device="cpu")
            for world in WORLDS}


@pytest.fixture(scope="module")
def jax_mesh():
    return j_make_mesh(4, ("views",))


# --- mesh helpers ------------------------------------------------------------

def test_mesh_helpers_on_one_gloo_rank():
    m = pmesh.make_mesh(device="cpu")
    try:
        assert (m.rank, m.size, m.shape, m.backend) == (0, 1,
                                                       {"views": 1}, "gloo")
        assert m.device == torch.device("cpu")
        x = torch.arange(12.0).reshape(6, 2)
        assert torch.equal(pmesh.shard_along(m, x), x)
        assert torch.equal(pmesh.replicated(m, x), x)
        assert torch.equal(pmesh.gather_along(m, x), x)
        assert pmesh.block_range(m, 6) == (0, 6)
        with pytest.raises(ValueError):
            pmesh.make_mesh(2, device="cpu")       # the group has one rank
        with pytest.raises(ValueError):
            pmesh.make_mesh(axis_names=("a", "b"), device="cpu")
    finally:
        m.close()
    assert not torch.distributed.is_initialized()


def test_helpers_run_their_collective_at_world_size_1(monkeypatch):
    """No short cut at one rank: a world-size-1 group (NCCL on the card)
    runs every collective the layer makes."""
    calls = []
    for name in ("all_reduce", "all_gather"):
        real = getattr(torch.distributed, name)
        monkeypatch.setattr(torch.distributed, name,
                            lambda *a, _f=real, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    m = pmesh.make_mesh(device="cpu")
    try:
        x = torch.arange(6.0)
        assert torch.equal(pmesh.all_reduce_sum(m, x.clone()), x)
        flags = x > 2.0
        assert torch.equal(pmesh.gather_along(m, flags), flags)
    finally:
        m.close()
    assert calls == ["all_reduce", "all_gather"]


def test_pad_to_multiple_and_window_spec():
    p, n = pmesh.pad_to_multiple(np.arange(10), 8)
    assert p.shape[0] == 16 and n == 10
    assert pmesh.pad_to_multiple(np.ones((4, 3)), 2, axis=1)[0].shape == (4,
                                                                          4)
    spec = view_windows.make_window_spec(64, 8, halo=1)
    assert spec.window(3) == (24, 32)
    assert spec.working_set(0) == (0, 9) and spec.working_set(7) == (55, 64)
    assert spec.working_set(4) == (31, 41)
    with pytest.raises(ValueError):
        view_windows.make_window_spec(63, 8)
    assert view_windows.edge_window_aligned(spec, n2=64, mesh_size=8)
    assert view_windows.edge_window_aligned(
        view_windows.make_window_spec(32, 8), n2=32, mesh_size=8)
    assert not view_windows.edge_window_aligned(
        view_windows.make_window_spec(6, 2), n2=3, mesh_size=4)


def test_make_mesh_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.run_spmd(pmesh.spmd_calls, 1, [])   # the card by default


def test_a_failing_rank_raises_with_its_traceback(inputs):
    d = torch.as_tensor(inputs["disp"][:4])
    cams = CameraBatch(*(torch.as_tensor(inputs[k][:4]) for k in "KRt"),
                       inputs["w"], inputs["h"])
    with pytest.raises(RuntimeError, match="halo 3 must lie in 1..2"):
        pmesh.run_spmd(view_windows.check_consistency_sharded, 2, d, cams,
                       halo=3, device="cpu", **KW)


# --- the windowed consistency filter -----------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("halo", HALOS)
def test_windowed_filter_equals_global_and_jax(inputs, ranks, jax_mesh,
                                               world, halo):
    disp, K, R, t, w, h = (inputs[k] for k in ("disp", "K", "R", "t", "w",
                                                "h"))
    offsets = tuple(o for o in range(-halo, halo + 1) if o)
    glob = check_consistency(
        torch.as_tensor(disp), CameraBatch(torch.as_tensor(K),
                                           torch.as_tensor(R),
                                           torch.as_tensor(t), w, h),
        offsets=offsets, **KW).numpy()
    jwin = np.asarray(j_windowed(jnp.asarray(disp), JCams(K, R, t, w, h),
                                 mesh=jax_mesh, halo=halo, **KW))
    for r, res in enumerate(ranks[world]):
        got = res[HALOS.index(halo)].numpy()
        np.testing.assert_array_equal(got, glob, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got, jwin, err_msg=f"rank {r}")
    kept = (glob > 0).mean()
    assert 0.01 < kept < 0.99, kept      # the filter does real work


# --- sharded BA --------------------------------------------------------------

@pytest.fixture(scope="module")
def ba_refs(inputs, jax_mesh):
    """JAX's sharded solve on the 4-device mesh and the port's solve_ba."""
    prob, _, _ = ba_problem()
    jb, jinit = inputs["jblocks"], inputs["jinit"]
    jst, jrmse = j_ba.solve_ba_sharded(jb, jinit, jax_mesh, iters=BA_ITERS)
    tprob = ba.make_problem(np.asarray(prob.K), np.asarray(prob.cam_idx),
                            np.asarray(prob.pt_idx), np.asarray(prob.uv), 64,
                            fixed_cams=list(BA_FIXED), n_cams=6,
                            device="cpu")
    tst, trmse = ba.solve_ba(tprob, ba_state_from_numpy(
        *(np.asarray(x) for x in jinit), device="cpu"), iters=BA_ITERS)
    return (jst, jrmse), (tst, trmse)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ba_matches_jax_and_unsharded(ranks, ba_refs, world):
    (jst, jrmse), (tst, trmse) = ba_refs
    for res in ranks[world]:
        st, rmse = res[len(HALOS)]
        assert rmse < 0.2
        for ref_st, ref_rmse in ((jst, jrmse), (tst, trmse)):
            assert abs(rmse - ref_rmse) < 0.1
            np.testing.assert_allclose(st.rvec.numpy(),
                                       np.asarray(ref_st.rvec), atol=2e-3)
            np.testing.assert_allclose(st.tvec.numpy(),
                                       np.asarray(ref_st.tvec), atol=2e-2)
        np.testing.assert_array_equal(st.points.numpy(),
                                      ranks[world][0][len(HALOS)][0]
                                      .points.numpy())


def test_ba_grouping_and_rmse_match_jax(inputs):
    prob, jb, jinit = ba_problem()
    tb = ba_dist.group_by_point(
        np.asarray(prob.K), np.asarray(prob.cam_idx), np.asarray(prob.pt_idx),
        np.asarray(prob.uv), 64, 6, max_obs_per_point=6, fixed_cams=BA_FIXED,
        device="cpu")
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    st = ba_state_from_numpy(*(np.asarray(x) for x in jinit), device="cpu")
    np.testing.assert_allclose(
        float(ba_dist.reprojection_rmse_blocks(tb, st)),
        float(j_ba.reprojection_rmse_blocks(jb, jinit)), rtol=1e-5)
    m = pmesh.make_mesh(device="cpu")
    try:        # one step on one rank: the unsharded gn_step's update
        got = ba_dist.gn_step_sharded(tb, st, 1e-3, mesh=m)
        want, _ = ba.gn_step(ba.make_problem(
            np.asarray(prob.K), np.asarray(prob.cam_idx),
            np.asarray(prob.pt_idx), np.asarray(prob.uv), 64,
            fixed_cams=list(BA_FIXED), n_cams=6, device="cpu"), st,
            torch.tensor(1e-3))
    finally:
        m.close()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


# --- sharded ARAP ------------------------------------------------------------

@pytest.fixture(scope="module")
def arap_refs(inputs, jax_mesh):
    """JAX's two sharded ARAP layouts on the 4-device mesh, and the port's
    unsharded arap_solve."""
    v, edges, wts, con, tgt = inputs["arap"]
    ep, wp = arap_dist.pad_edges(edges, wts, 4)
    jout = np.asarray(j_arap_sharded(JD.ARAPProblem(
        jnp.asarray(v), jnp.asarray(ep), jnp.asarray(wp), jnp.asarray(con),
        jnp.asarray(tgt)), mesh=jax_mesh, **ARAP_KW))
    jblk = np.asarray(j_blocks.arap_solve_blocks(
        j_blocks.build_blocks(v, edges, wts, con, tgt, 4), mesh=jax_mesh,
        **ARAP_KW))
    tout = TD.arap_solve(_t_arap(v, edges, wts, con, tgt), **ARAP_KW).numpy()
    return jout, jblk, tout


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("layout", ["edges", "blocks"])
def test_sharded_arap_matches_jax_and_unsharded(inputs, ranks, arap_refs,
                                                world, layout):
    jout, jblk, tout = arap_refs
    k = len(HALOS) + (1 if layout == "edges" else 2)
    for res in ranks[world]:
        out = res[k].numpy()
        np.testing.assert_allclose(out, inputs["moved"], atol=0.03)
        np.testing.assert_allclose(out, tout, atol=5e-3)
        np.testing.assert_allclose(out, jout if layout == "edges" else jblk,
                                   atol=5e-3)
        np.testing.assert_array_equal(out, ranks[world][0][k].numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_build_blocks_matches_jax(inputs, world):
    v, edges, wts, con, tgt = inputs["arap"]
    got = arap_blocks.build_blocks(v, edges, wts, con, tgt, world)
    want = j_blocks.build_blocks(v, edges, wts, con, tgt, world)
    for a, b in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.n_vertices == want.n_vertices


def test_block_state_bytes_on_the_100k_strip():
    """1000 x 100 grid strip over 8 blocks: a block plus its halo table is
    a small fraction of the replicated V x 3 state (host only)."""
    rows, cols = 1000, 100
    V = rows * cols
    yy, xx = np.mgrid[0:rows, 0:cols]
    v = np.stack([xx.ravel(), yy.ravel(), np.zeros(V)], -1).astype(
        np.float32) * 0.01
    idx = np.arange(V).reshape(rows, cols)
    edges = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], -1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], -1)])
    con = np.zeros(V, bool)
    con[idx[0]] = True
    tgt = np.where(con[:, None], v + 0.05, 0.0)
    blocks = arap_blocks.build_blocks(v, edges, np.ones(len(edges)), con,
                                      tgt, 8)
    per = arap_blocks.per_device_state_bytes(blocks)
    assert per < V * 3 * 4 / 4, per
    assert per == j_blocks.per_device_state_bytes(
        j_blocks.build_blocks(v, edges, np.ones(len(edges)), con, tgt, 8))
