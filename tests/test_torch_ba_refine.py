"""Bundle-adjustment refinement of the chain (pipeline/ba_refine) and the
refined align paths: ports of tests/test_ba_refine.py's cases, and
align_sequences(refine=...) on the demo against the ground truth.
build_ba_problem and refit_similarities are held against the JAX package
on JAX's own candidates and chain in tests/test_torch_align_slice.py,
whose fixture has the JAX edge sweep compiled already.

Tolerances: _rotmat_to_rvec and _nearest_rotation within 1e-6 (the same
float64 host code); refit_similarities recovers a known similarity
within 1e-4; the refined demo alignments within test_e2e_align's bounds (s 5 %,
rotation 3 deg, translation 0.08), with the BA RMSE not above its start
(+1e-6); on two synthetic rings with 15 % wrong matches, the outlier drop
recovers the similarity (0.2 deg, 0.2 %) where the solve on every
observation keeps the chain's 6 degrees."""

import numpy as np
import pytest
import torch

from multiviewstitch_tpu.pipeline import ba_refine as jbr
from multiviewstitch_tpu_torch.core.transforms import (Similarity,
                                                       rotation_angle_deg)
from multiviewstitch_tpu_torch.interop import (ba_state_from_numpy,
                                               candidate_from_numpy,
                                               similarity_from_numpy)
from multiviewstitch_tpu_torch.pipeline import ba_refine as br
from multiviewstitch_tpu_torch.solvers.ba import rodrigues

torch.set_num_threads(2)


def _rand_rot(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class _Cams:
    def __init__(self, R, t, K=None):
        self.R = torch.as_tensor(np.asarray(R, np.float32))
        self.t = torch.as_tensor(np.asarray(t, np.float32))
        if K is not None:
            self.K = torch.as_tensor(np.asarray(K, np.float32))


class _Seq:
    def __init__(self, cams):
        self.cams = cams


def test_rotmat_to_rvec_and_nearest_rotation_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        R = _rand_rot(rng)
        rv = br._rotmat_to_rvec(R.astype(np.float32))
        np.testing.assert_allclose(
            rv, jbr._rotmat_to_rvec(R.astype(np.float32)), atol=1e-6)
        np.testing.assert_allclose(rodrigues(torch.as_tensor(rv)).numpy(), R,
                                   atol=2e-5)
        M = R + 0.05 * rng.normal(size=(3, 3))
        np.testing.assert_allclose(br._nearest_rotation(M),
                                   jbr._nearest_rotation(M), atol=1e-6)
    # identity and a half turn
    np.testing.assert_allclose(br._rotmat_to_rvec(np.eye(3, dtype=np.float32)),
                               0.0, atol=1e-8)
    Rpi = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    np.testing.assert_allclose(
        rodrigues(torch.as_tensor(br._rotmat_to_rvec(Rpi))).numpy(), Rpi,
        atol=1e-4)


def test_nearest_rotation_matches_svd_optimum():
    rng = np.random.default_rng(1)
    R = _rand_rot(rng)
    Rn = br._nearest_rotation(R + 0.05 * rng.normal(size=(3, 3)))
    np.testing.assert_allclose(Rn @ Rn.T, np.eye(3), atol=1e-5)
    assert np.linalg.det(Rn) > 0
    ang = np.degrees(np.arccos(np.clip((np.trace(Rn @ R.T) - 1) / 2, -1, 1)))
    assert ang < 5.0


def test_refit_recovers_known_similarity():
    """Exact cameras composed through a known similarity, re-fit: >= 2
    frames recover the scale too; 1 frame keeps the chain scale."""
    rng = np.random.default_rng(2)
    n = 3
    Rf = np.stack([_rand_rot(rng) for _ in range(n)])
    tf = rng.normal(size=(n, 3))
    s, RT = 1.27, _rand_rot(rng)
    tT = np.asarray([0.3, -0.2, 0.45])
    Rp = np.einsum("nij,kj->nik", Rf, RT)       # R_f @ R_T^T
    tp = -np.einsum("nij,j->ni", Rp, tT) + s * tf
    rv = np.stack([br._rotmat_to_rvec(Rp[i].astype(np.float32))
                   for i in range(n)])
    st = ba_state_from_numpy(rv, tp, np.zeros((1, 3)), device="cpu")
    seqs = [_Seq(_Cams(Rf, tf)), _Seq(_Cams(Rf[:1], tf[:1]))]
    # the chain's scale is wrong: the least squares recovers the true one
    init = [similarity_from_numpy(1.0, RT, tT, "cpu"),
            Similarity.identity(device="cpu")]
    out = br.refit_similarities(seqs, init, st, {(0, i): i for i in range(n)})
    np.testing.assert_allclose(float(out[0].s), s, rtol=1e-4)
    np.testing.assert_allclose(out[0].R.numpy(), RT, atol=1e-4)
    np.testing.assert_allclose(out[0].t.numpy(), tT, atol=1e-3)
    assert float(out[1].s) == 1.0
    init1 = [similarity_from_numpy(s, RT, np.zeros(3), "cpu"),
             Similarity.identity(device="cpu")]
    out1 = br.refit_similarities(seqs, init1, st, {(0, 0): 0})
    np.testing.assert_allclose(float(out1[0].s), s, rtol=1e-6)
    np.testing.assert_allclose(out1[0].t.numpy(), tT, atol=1e-3)


def test_refine_skips_on_mismatched_intrinsics():
    """BA shares one K: a participating frame with other intrinsics skips
    BA (ba_skipped = 1, the chain returned); a frame that takes no part
    may differ freely."""
    rng = np.random.default_rng(5)
    n = 20
    R1 = np.stack([_rand_rot(rng) for _ in range(2)])
    t1 = rng.normal(size=(2, 3)) * 0.1 + np.asarray([0, 0, 2.0])
    K = np.asarray([[80.0, 0, 31.5], [0, 80.0, 23.5], [0, 0, 1]], np.float32)
    pts_w = rng.normal(size=(n, 3)) * 0.4
    s, RT, tT = 1.1, _rand_rot(rng), np.asarray([0.1, 0.05, -0.08])

    def project(Rf, tf, X):
        pc = Rf @ X + tf
        return np.asarray([K[0, 0] * pc[0] / pc[2] + K[0, 2],
                           K[1, 1] * pc[1] / pc[2] + K[1, 2]])
    Rp0 = R1[0] @ RT.T
    tp0 = -Rp0 @ tT + s * t1[0]
    p1 = (RT.T @ (pts_w - tT).T).T / s            # seq-0 world lifts
    c = candidate_from_numpy(
        0, 1, np.stack([project(Rp0, tp0, X) for X in pts_w]),
        np.stack([project(R1[1], t1[1], X) for X in pts_w]), p1, pts_w,
        np.ones(n, bool), 0.0, n)
    init = [similarity_from_numpy(s, RT, tT, "cpu"),
            Similarity.identity(device="cpu")]
    same = np.tile(K, (2, 1, 1))
    diff = same.copy()
    diff[1, 0, 0] = 95.0
    seqs = [_Seq(_Cams(R1, t1, same)), _Seq(_Cams(R1, t1, diff))]
    out, m = br.refine_with_ba(seqs, [(0, 1, c)], init, iters=4)
    assert m.get("ba_skipped") == 1.0
    assert float(out[0].s) == float(init[0].s)
    seqs2 = [_Seq(_Cams(R1, t1, diff)), _Seq(_Cams(R1, t1, same))]
    _, m2 = br.refine_with_ba(seqs2, [(0, 1, c)], init, iters=4)
    assert "ba_rmse_px" in m2 and m2.get("ba_skipped", 0) == 0


def _check_gt(T, gt):
    assert abs(float(T.s) - float(gt.s)) <= 0.05 * float(gt.s)
    assert rotation_angle_deg(T.R, gt.R.numpy()) < 3.0
    assert np.linalg.norm(T.t.numpy() - gt.t.numpy()) < 0.08


@pytest.fixture(scope="module")
def demo():
    from multiviewstitch_tpu_torch.cli import build_demo_sequences
    from multiviewstitch_tpu_torch.pipeline.match_edges import prep_sequence
    from multiviewstitch_tpu_torch.cli import demo_config
    seqs, gt, _, _ = build_demo_sequences("cpu")
    cfg = demo_config()
    return seqs, gt, cfg, [prep_sequence(s, cfg) for s in seqs]


@pytest.mark.parametrize("refine", ["ba", True])
def test_align_refined_recovers_gt(demo, refine):
    from multiviewstitch_tpu_torch.pipeline.align_seq import align_sequences
    seqs, gt, cfg, preps = demo
    res = align_sequences(seqs, cfg, seed=0, preps=preps, refine=refine)
    print(refine, res.metrics)
    _check_gt(res.transforms[0], gt)
    if refine == "ba":
        assert set(res.metrics) == {"ba_rmse_init_px", "ba_rmse_px",
                                    "ba_cams", "ba_tracks", "ba_obs"}
        m = res.metrics
        assert m["ba_rmse_px"] <= m["ba_rmse_init_px"] + 1e-6
        assert m["ba_cams"] >= 2
    else:
        assert set(res.metrics) == {"pose_graph_rmse", "pose_graph_edges"}
        assert res.metrics["pose_graph_rmse"] < 0.05


def test_all_pairs_adds_the_skip_edges(demo):
    """Three sequences (the third the base scene moved by a second
    similarity): all_pairs matches (0, 2) too, and the pose graph counts
    its candidate edges."""
    from multiviewstitch_tpu_torch.pipeline.align_seq import (
        Sequence, align_sequences)
    from multiviewstitch_tpu_torch.pipeline.fixtures import (make_scene,
                                                             textured_views)
    seqs, gt, cfg, preps = demo
    gt2 = similarity_from_numpy(0.9, np.eye(3), [0.05, 0.0, -0.1], "cpu")
    third = make_scene(n_frames=5, width=128, height=96, bumps=0.15,
                       n_lat=64, n_lon=96, arc_deg=45.0, transform=gt2,
                       device="cpu")
    from multiviewstitch_tpu_torch.pipeline.match_edges import prep_sequence
    s3 = Sequence(textured_views(third), third.disparity, third.cams)
    seqs3, preps3 = seqs + [s3], preps + [prep_sequence(s3, cfg)]
    chain = align_sequences(seqs3, cfg, preps=preps3, refine=True)
    both = align_sequences(seqs3, cfg, preps=preps3, refine=True,
                           all_pairs=True)
    print(chain.metrics, both.metrics)
    assert both.metrics["pose_graph_edges"] > chain.metrics["pose_graph_edges"]
    # seq 0 -> seq 2 maps base -> third: gt2 o inverse(gt) o gt = gt2
    T = both.transforms[0]
    assert abs(float(T.s) - 0.9) <= 0.05 * 0.9
    assert rotation_angle_deg(T.R, np.eye(3)) < 3.0


def _yaw(deg):
    a = np.radians(deg)
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]])


def _ring_with_outliers(rng, n=12, frac_out=0.15):
    """Two rings of n portrait 480x640 cameras around one cloud, sequence 0
    in its own world (the reference frame mapped by s 1.12, 9 degrees
    about +y); frame i of sequence 0 matched to frames i and i+1 of
    sequence 1, with ``frac_out`` of the matches moved 40-150 px (wrong
    matches RANSAC kept); the chain off by 6 degrees and 3 % in scale."""
    from multiviewstitch_tpu_torch.pipeline.fixtures import ring_cameras
    cams = ring_cameras(n, radius=2.4, width=480, length_focal=525.0,
                        img_height=640, device="cpu")
    s, RT, tT = 1.12, _yaw(9.0), np.array([0.12, -0.06, 0.1])
    X = rng.uniform(-0.3, 0.3, size=(400, 3)) * [1, 3, 1]
    X0 = ((X - tT) @ RT) / s
    K = cams.K[0].double().numpy()

    def proj(f, P):
        pc = P @ cams.R[f].double().numpy().T + cams.t[f].double().numpy()
        return np.round(np.stack([K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2],
                                  K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]],
                                 1)).astype(np.int32)
    pairs, n_bad = [], 0
    for i in range(n):
        for j in (i, (i + 1) % n):
            idx = rng.choice(len(X), 40, replace=False)
            uv2 = proj(j, X[idx])
            bad = rng.random(len(idx)) < frac_out
            n_bad += int(bad.sum())
            uv2[bad] += (rng.choice([-1, 1], size=(int(bad.sum()), 2)) *
                         rng.uniform(40, 150, size=(int(bad.sum()), 2))
                         ).astype(np.int32)
            pairs.append((0, 1, candidate_from_numpy(
                i, j, proj(i, X0[idx]), uv2, X0[idx], X[idx],
                np.ones(len(idx), bool), 0.0, len(idx))))
    init = [similarity_from_numpy(s * 1.03, _yaw(6.0) @ RT, tT + 0.02, "cpu"),
            Similarity.identity(device="cpu")]
    return [_Seq(cams), _Seq(cams)], pairs, init, (s, RT, tT), n_bad


def test_refine_drops_the_outliers_and_recovers_the_similarity(monkeypatch):
    """The body rings' failure, synthetic: with 15 % wrong matches the LM
    on every observation accepts no step (each overshoots until the
    damping caps) and the chain's 6-degree error stays; without the
    observations the chain reprojects far off, BA recovers the similarity
    (rotation within 0.2 degrees, scale within 0.2 %)."""
    from multiviewstitch_tpu_torch.utils import profiling
    seqs, pairs, init, (s, RT, tT), n_bad = _ring_with_outliers(
        np.random.default_rng(3))
    profiling.reset_counters("ba.")
    out, m = br.refine_with_ba(seqs, pairs, init)
    c = profiling.counters("ba.")
    assert rotation_angle_deg(out[0].R, RT) < 0.2
    assert abs(float(out[0].s) - s) < 0.002 * s
    assert np.linalg.norm(out[0].t.numpy() - tT) < 0.005
    assert n_bad <= c["ba.outliers"] <= 1.05 * n_bad
    assert m["ba_obs"] == c["ba.observations"] - c["ba.outliers"]
    assert m["ba_rmse_px"] < 0.5 and c["ba.lm_accepted"] >= 1
    # every observation in the solve: nothing accepted, the chain kept
    monkeypatch.setattr(br, "OUTLIER_MEDIANS", float("inf"))
    profiling.reset_counters("ba.")
    out, m = br.refine_with_ba(seqs, pairs, init)
    assert profiling.counters("ba.").get("ba.lm_accepted", 0) == 0
    assert rotation_angle_deg(out[0].R, RT) > 5.0
