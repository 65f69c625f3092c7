"""Bundle adjustment: the port's solvers/ba against the JAX package's on the
same numpy problem (8 cameras on an arc, 256 points), and ports of
tests/test_ba.py's cases.

Tolerances: rodrigues and the right Jacobian within 1e-5; the closed-form
projection Jacobians within 1e-5 of the largest entry (float32, the same
formulas in another summation order); against torch.func.jacfwd of the
residual the JAX test's rtol 2e-3 / atol 1e-3 (forward-mode through
sin(t)/t loses digits at small angles); make_problem / apply_mask arrays
equal; one gn_step within 1e-4; solve_ba (20 iterations) final RMSE
within 1e-4 px and state within 1e-3."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiviewstitch_tpu.solvers import ba as jba
from multiviewstitch_tpu_torch.interop import (ba_problem_from_numpy,
                                               ba_state_from_numpy)
from multiviewstitch_tpu_torch.solvers import ba

torch.set_num_threads(2)

N_CAMS, N_PTS = 8, 256
K = np.array([[200.0, 0, 120.0], [0, 200.0, 90.0], [0, 0, 1]], np.float32)


def synth(n_cams=N_CAMS, n_pts=N_PTS, noise_px=0.0, pose_noise=0.0,
          pt_noise=0.0, seed=0):
    """tests/test_ba.py's synthetic problem as numpy: cameras on an arc
    looking at a point cloud, observations = projections (+ noise).
    Returns (cam_idx, pt_idx, uv, gt (rvec, tvec, pts), init)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    rvec = np.stack([np.array([0.0, (i - n_cams / 2) * 0.08, 0.0],
                              np.float32) for i in range(n_cams)])
    tvec = np.stack([np.array([0.15 * i, 0.0, 0.2 * abs(r[1])], np.float32)
                     for i, r in enumerate(rvec)])
    cam_idx, pt_idx, uvs = [], [], []
    for c in range(n_cams):
        R = ba.rodrigues(torch.as_tensor(rvec[c])).numpy()
        pc = (R @ pts.T).T + tvec[c]
        uv = np.stack([K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2],
                       K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]], -1)
        inb = ((uv[:, 0] > 0) & (uv[:, 0] < 240) &
               (uv[:, 1] > 0) & (uv[:, 1] < 180))
        for p in np.nonzero(inb)[0]:
            cam_idx.append(c)
            pt_idx.append(p)
            uvs.append(uv[p] + rng.normal(size=2) * noise_px)
    init = (rvec + rng.normal(size=rvec.shape).astype(np.float32) *
            pose_noise,
            tvec + rng.normal(size=tvec.shape).astype(np.float32) *
            pose_noise * 3,
            pts + rng.normal(size=pts.shape).astype(np.float32) * pt_noise)
    return (np.asarray(cam_idx), np.asarray(pt_idx),
            np.asarray(uvs, np.float32), (rvec, tvec, pts),
            tuple(a.astype(np.float32) for a in init))


def problems(n_cams=N_CAMS, fixed_cams=None, **kw):
    """(port problem, JAX problem, port gt, port init, JAX init)."""
    cam_idx, pt_idx, uv, gt, init = synth(n_cams=n_cams, **kw)
    n_pts = len(gt[2])
    tp = ba.make_problem(K, cam_idx, pt_idx, uv, n_pts,
                         max_obs_per_point=n_cams, fixed_cams=fixed_cams,
                         n_cams=n_cams, device="cpu")
    jp = jba.make_problem(K, cam_idx, pt_idx, uv, n_pts,
                          max_obs_per_point=n_cams, fixed_cams=fixed_cams,
                          n_cams=n_cams)
    return (tp, jp, ba_state_from_numpy(*gt, device="cpu"),
            ba_state_from_numpy(*init, device="cpu"),
            jba.BAState(*(jnp.asarray(a) for a in init)))


def _random_poses(n=64, seed=0):
    rng = np.random.default_rng(seed)
    rv = rng.normal(size=(n, 3)).astype(np.float32) * 0.7
    rv[:8] *= 1e-6                                  # small-angle branch
    tv = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    X = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    X[:, 2] += 4.0
    uv = rng.uniform(0, 640, size=(n, 2)).astype(np.float32)
    Kp = np.array([[400.0, 0, 320.0], [0, 380.0, 240.0], [0, 0, 1]],
                  np.float32)
    return Kp, rv, tv, X, uv


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale)


def test_rodrigues_and_right_jacobian_match_jax():
    _, rv, _, _, _ = _random_poses()
    _close(ba.rodrigues(torch.as_tensor(rv)), jba.rodrigues(jnp.asarray(rv)),
           1e-5)
    _close(ba._so3_right_jacobian(torch.as_tensor(rv)),
           jba._so3_right_jacobian(jnp.asarray(rv)), 1e-5)
    # the JAX test's axis-angle cases
    R = ba.rodrigues(torch.tensor([0.0, 0.0, np.pi / 2])).numpy()
    np.testing.assert_allclose(R @ np.array([1, 0, 0]), [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(ba.rodrigues(torch.tensor([1e-9, 0.0, 0.0])),
                               np.eye(3), atol=1e-7)


def test_projection_jacobians_match_jax():
    Kp, rv, tv, X, uv = _random_poses()
    got = ba.projection_jacobians(*(torch.as_tensor(a)
                                    for a in (Kp, rv, tv, X, uv)))
    want = jba.projection_jacobians(*(jnp.asarray(a)
                                      for a in (Kp, rv, tv, X, uv)))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_projection_jacobians_match_torch_func_jacfwd():
    """The closed form against forward-mode autodiff of one observation's
    residual, near-zero rotations included (the JAX test's tolerances)."""
    from torch.func import jacfwd, vmap
    Kp, rv, tv, X, uv = (torch.as_tensor(a) for a in _random_poses())
    r, Jc, Jp = ba.projection_jacobians(Kp, rv, tv, X, uv)

    def one(cam6, x, u):     # a batch of one (0-dim forward-mode tangents
        #                        of python-scalar ops come out float64)
        return ba.projection_jacobians(Kp, cam6[None, :3], cam6[None, 3:],
                                       x[None], u[None])[0][0]
    cam6 = torch.cat([rv, tv], -1)
    Jc2 = vmap(jacfwd(one, argnums=0))(cam6, X, uv)
    Jp2 = vmap(jacfwd(one, argnums=1))(cam6, X, uv)
    np.testing.assert_allclose(Jp.numpy(), Jp2.numpy(), rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(Jc.numpy(), Jc2.numpy(), rtol=2e-3, atol=1e-3)


def _problem_equal(tp, jp):
    for name in jba.BAProblem._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)


def test_make_problem_and_apply_mask_equal_jax():
    tp, jp, _, _, _ = problems(pose_noise=0.01, pt_noise=0.02)
    _problem_equal(tp, jp)
    keep = np.random.default_rng(1).random(len(tp.cam_idx)) > 0.1
    _problem_equal(ba.apply_mask(tp, keep), jba.apply_mask(jp, keep))
    # interop hands JAX's exact problem to the port
    _problem_equal(ba_problem_from_numpy(
        *(np.asarray(x) for x in jp), device="cpu"), jp)


# The parity cases fix the first and the last camera: with one fixed
# camera the scene's scale is a free direction of the problem (a gauge),
# along which float32 rounding walks each solver its own way (the RMSE
# agrees to 1e-6 px while the states part by ~1 % in scale).
PINNED = [0, N_CAMS - 1]


def test_gn_step_matches_jax():
    tp, jp, _, ti, ji = problems(fixed_cams=PINNED, pose_noise=0.01,
                                 pt_noise=0.02)
    got, gnorm = ba.gn_step(tp, ti, torch.tensor(1e-3))
    want, wnorm = jba.gn_step(jp, ji, jnp.float32(1e-3), num_cams=N_CAMS,
                              num_points=N_PTS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-4)
    # the fixed camera does not move
    assert torch.equal(got.rvec[0], ti.rvec[0])


def test_solve_ba_matches_jax():
    tp, jp, _, ti, ji = problems(fixed_cams=PINNED, noise_px=0.5,
                                 pose_noise=0.005, pt_noise=0.01, seed=2)
    st, rmse = ba.solve_ba(tp, ti, iters=20)
    jst, jrmse = jba.solve_ba(jp, ji, iters=20)
    print(f"BA 20 iterations: port rmse {rmse:.6f}, jax {jrmse:.6f}")
    assert abs(rmse - jrmse) <= 1e-4
    for g, w in zip(st, jst):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)


def test_zero_residual_at_ground_truth():
    tp, _, gt, _, _ = problems()
    assert float(ba.reprojection_rmse(tp, gt)) < 1e-3


def test_ba_converges_from_perturbed_state():
    tp, _, _, ti, _ = problems(pose_noise=0.01, pt_noise=0.02)
    rmse0 = float(ba.reprojection_rmse(tp, ti))
    assert rmse0 > 1.0
    _, rmse = ba.solve_ba(tp, ti, iters=25)
    assert rmse < 0.05 * rmse0 and rmse < 0.2


def test_ba_with_pixel_noise_reaches_noise_floor():
    tp, _, _, ti, _ = problems(noise_px=0.5, pose_noise=0.005, pt_noise=0.01)
    _, rmse = ba.solve_ba(tp, ti, iters=25)
    assert rmse < 1.0


def test_gauge_fixed_camera_untouched():
    tp, _, _, ti, _ = problems(pose_noise=0.01, pt_noise=0.02)
    st, _ = ba.solve_ba(tp, ti, iters=10)
    assert torch.equal(st.rvec[0], ti.rvec[0])
    assert torch.equal(st.tvec[0], ti.tvec[0])


def test_make_problem_exact_gradient_no_silent_cap():
    """Default capacity covers every observation; an explicit smaller cap
    warns and measurably biases the optimum."""
    import warnings
    cam_idx, pt_idx, uv, _, init = synth(n_cams=6, pose_noise=0.01,
                                         pt_noise=0.02)
    st0 = ba_state_from_numpy(*init, device="cpu")
    prob = ba.make_problem(K, cam_idx, pt_idx, uv, N_PTS, device="cpu")
    assert int(prob.pt_obs_mask.sum()) == int(prob.mask.sum())
    _, rmse_full = ba.solve_ba(prob, st0, iters=25)
    assert rmse_full < 0.2
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        capped = ba.make_problem(K, cam_idx, pt_idx, uv, N_PTS,
                                 max_obs_per_point=3, n_cams=6, device="cpu")
    assert any("drops" in str(w.message) for w in rec)
    _, rmse_capped = ba.solve_ba(capped, st0, iters=25)
    assert rmse_capped > 10 * max(rmse_full, 1e-4)


def test_apply_mask_consistent():
    """apply_mask updates both the flat and the grouped mask, so gn_step
    optimizes exactly the set reprojection_rmse scores."""
    cam_idx, pt_idx, uv, _, init = synth(n_cams=6, pose_noise=0.01,
                                         pt_noise=0.02, seed=3)
    st0 = ba_state_from_numpy(*init, device="cpu")
    rng = np.random.default_rng(0)
    uv = uv.copy()
    bad = rng.random(len(uv)) < 0.10
    uv[bad] += rng.uniform(30, 80, size=(int(bad.sum()), 2))
    noisy = ba.make_problem(K, cam_idx, pt_idx, uv, N_PTS, n_cams=6,
                            device="cpu")
    masked = ba.apply_mask(noisy, ~bad)
    assert int(masked.pt_obs_mask.sum()) == int(masked.mask.sum())
    _, rmse = ba.solve_ba(masked, st0, iters=25)
    assert rmse < 0.2
    inconsistent = noisy._replace(mask=torch.as_tensor(~bad))
    _, rmse_bad = ba.solve_ba(inconsistent, st0, iters=25)
    assert rmse < rmse_bad
