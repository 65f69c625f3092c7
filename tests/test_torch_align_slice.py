"""The align slice end to end: the port against the JAX package on the JAX
fixture of tests/test_e2e_align (two 4-frame sequences related by a known
similarity), and the port's CLI entry point.

Bounds: both recover gt within test_e2e_align's bounds (s 5 %, rotation
3 deg, translation 0.08); the two solutions agree within 2 % in s and
1.5 deg in rotation (RANSAC draws differ: JAX threefry, torch Philox);
both fused clouds have RMSE < 0.05 to the moved mesh and their point
counts agree within 10 %. On JAX's own candidates and chain (handed over
through interop), the port's build_ba_problem gives equal integer arrays
and camera map and an initial state within 1e-5, and refit_similarities
re-fits JAX's refined cameras within 1e-4."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiviewstitch_tpu.core.transforms import Similarity as JSim
from multiviewstitch_tpu.ops.tsdf import fuse_multi_sequence as j_fuse_multi
from multiviewstitch_tpu.pipeline import ba_refine as jbr
from multiviewstitch_tpu.pipeline.align_seq import (
    align_sequences as j_align, fuse_sequences as j_fuse,
    match_sequence_pair as j_match_pair)
from multiviewstitch_tpu.solvers.ba import solve_ba as j_solve_ba
from multiviewstitch_tpu_torch.core.transforms import rotation_angle_deg
from multiviewstitch_tpu_torch.interop import (ba_state_from_numpy,
                                               candidate_from_numpy,
                                               sequence_from_numpy,
                                               similarity_from_numpy)
from multiviewstitch_tpu_torch.pipeline import ba_refine as br
from multiviewstitch_tpu_torch.io.srt import load_srt
from multiviewstitch_tpu_torch.ops.tsdf import fuse_multi_sequence
from multiviewstitch_tpu_torch.pipeline.align_seq import (align_sequences,
                                                          fuse_sequences)
from multiviewstitch_tpu_torch.solvers.unionfind import (
    retain_largest_component)
from test_e2e_align import CFG, build_two_sequences

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rmse_to(points, verts):
    d = []
    for c in range(0, len(points), 4096):
        chunk = points[c:c + 4096]
        d.append(np.sqrt(((chunk[:, None] - verts[None]) ** 2).sum(-1)
                         .min(1)))
    d = np.concatenate(d)
    return float(np.sqrt((d ** 2).mean()))


def _check_gt(s, R, t, gt):
    assert abs(s - float(gt.s)) <= 0.05 * float(gt.s)
    assert rotation_angle_deg(R, np.asarray(gt.R)) < 3.0
    assert np.linalg.norm(np.asarray(t) - np.asarray(gt.t)) < 0.08


@pytest.fixture(scope="module")
def slice_runs():
    seq1, seq2, gt, base, moved = build_two_sequences(n_frames=4)
    jres = j_align([seq1, seq2], CFG, seed=0)
    jpts, jnrm = j_fuse([seq1, seq2], jres, CFG)
    jv, jf, _ = j_fuse_multi([np.asarray(s.disparity) for s in (seq1, seq2)],
                             [s.cams for s in (seq1, seq2)], jres.transforms,
                             grid=48, min_dsp=CFG.min_dsp,
                             max_dsp=CFG.max_dsp)
    tseqs = [sequence_from_numpy(np.asarray(s.gray), np.asarray(s.disparity),
                                 np.asarray(s.cams.K), np.asarray(s.cams.R),
                                 np.asarray(s.cams.t), s.cams.width,
                                 s.cams.height, "cpu") for s in (seq1, seq2)]
    tres = align_sequences(tseqs, CFG, seed=0)
    tpts, tnrm = fuse_sequences(tseqs, tres, CFG)
    tv, tf, _ = fuse_multi_sequence([s.disparity for s in tseqs],
                                    [s.cams for s in tseqs], tres.transforms,
                                    grid=48, min_dsp=CFG.min_dsp,
                                    max_dsp=CFG.max_dsp)
    return dict(gt=gt, moved=moved, jres=jres, jpts=jpts, jmesh=(jv, jf),
                tres=tres, tpts=tpts, tnrm=tnrm, tmesh=(tv, tf),
                jseqs=[seq1, seq2], tseqs=tseqs)


def test_both_recover_gt_and_agree(slice_runs):
    r = slice_runs
    jT, tT = r["jres"].transforms[0], r["tres"].transforms[0]
    _check_gt(float(jT.s), np.asarray(jT.R), np.asarray(jT.t), r["gt"])
    _check_gt(float(tT.s), tT.R.numpy(), tT.t.numpy(), r["gt"])
    assert abs(float(tT.s) - float(jT.s)) <= 0.02 * float(jT.s)
    assert rotation_angle_deg(tT.R, np.asarray(jT.R)) < 1.5
    last = r["tres"].transforms[1]
    assert float(last.s) == 1.0 and torch.equal(last.R, torch.eye(3))
    assert len(r["tres"].keyframes) == 1


def test_fused_clouds_match_surface_and_each_other(slice_runs):
    r = slice_runs
    mv = r["moved"].vertices
    jr, tr_ = _rmse_to(r["jpts"], mv), _rmse_to(r["tpts"], mv)
    nj, nt = len(r["jpts"]), len(r["tpts"])
    print(f"fused points jax {nj} (rmse {jr:.4f}), port {nt} "
          f"(rmse {tr_:.4f})")
    assert jr < 0.05 and tr_ < 0.05
    assert nt > 2000 and abs(nt - nj) <= 0.1 * nj
    np.testing.assert_allclose(np.linalg.norm(r["tnrm"], axis=1), 1.0,
                               atol=1e-3)


def test_tsdf_meshes_agree(slice_runs):
    (jv, jf), (tv, tf) = slice_runs["jmesh"], slice_runs["tmesh"]
    print(f"TSDF mesh jax {len(jv)}/{len(jf)}, port {len(tv)}/{len(tf)}")
    assert len(tv) > 500 and abs(len(tv) - len(jv)) <= 0.1 * len(jv)
    kv, kf, _ = retain_largest_component(tv, tf)
    assert 0 < len(kf) <= len(tf) and kf.max() < len(kv)


@pytest.fixture(scope="module")
def jax_ba_inputs(slice_runs):
    """JAX's candidates (its edge sweep, compiled by slice_runs) and chain,
    and the same inputs as the port's objects."""
    seq1, seq2 = slice_runs["jseqs"]
    T, _, cands = j_match_pair(seq1, seq2, CFG, jax.random.key(0))
    jchain = [T, JSim(jnp.float32(1.0), jnp.eye(3), jnp.zeros(3))]
    jpairs = [(0, 1, c) for c in cands
              if c.num_matches >= CFG.min_match_count]
    tchain = [similarity_from_numpy(np.asarray(x.s), np.asarray(x.R),
                                    np.asarray(x.t), "cpu") for x in jchain]
    tpairs = [(k, l, candidate_from_numpy(
        c.frame_i, c.frame_j, c.uv1, c.uv2, c.p1, c.p2, c.mask, c.residual,
        c.num_matches)) for k, l, c in jpairs]
    return dict(jseqs=[seq1, seq2], jchain=jchain, jpairs=jpairs,
                tseqs=slice_runs["tseqs"], tchain=tchain, tpairs=tpairs)


def test_build_ba_problem_matches_jax(jax_ba_inputs):
    r = jax_ba_inputs
    assert len(r["jpairs"]) >= 2
    jprob, jst0, jmap = jbr.build_ba_problem(r["jseqs"], r["jpairs"],
                                             r["jchain"])
    prob, st0, cmap = br.build_ba_problem(r["tseqs"], r["tpairs"],
                                          r["tchain"])
    assert cmap == jmap
    for name in ("cam_idx", "pt_idx", "pt_obs", "pt_obs_mask", "cam_of",
                 "fixed_cams", "mask", "uv", "uv_g", "K"):
        np.testing.assert_array_equal(getattr(prob, name).numpy(),
                                      np.asarray(getattr(jprob, name)), name)
    for g, w in zip(st0, jst0):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    print(f"BA problem: {len(cmap)} cameras, {len(st0.points)} tracks, "
          f"{int(prob.mask.sum())} observations")


def test_refit_similarities_matches_jax(jax_ba_inputs):
    """Both re-fit the same refined cameras (JAX's solve) into the chain."""
    r = jax_ba_inputs
    jprob, jst0, jmap = jbr.build_ba_problem(r["jseqs"], r["jpairs"],
                                             r["jchain"])
    jst, _ = j_solve_ba(jprob, jst0, iters=30)
    want = jbr.refit_similarities(r["jseqs"], r["jchain"], jst, jmap)
    got = br.refit_similarities(r["tseqs"], r["tchain"], ba_state_from_numpy(
        *(np.asarray(x) for x in jst), device="cpu"), jmap)
    for T, J in zip(got, want):
        assert abs(float(T.s) - float(J.s)) <= 1e-4
        np.testing.assert_allclose(T.R.numpy(), np.asarray(J.R), atol=1e-4)
        np.testing.assert_allclose(T.t.numpy(), np.asarray(J.t), atol=1e-4)


def test_turned_ring_recovers_gt_through_run_align(tmp_path):
    """The second sequence's camera ring turned by half a frame step: no
    keyframe pair shares a pose, so the solve is not exact and RANSAC has
    to score the matches. Same gt bounds as test_e2e_align."""
    from multiviewstitch_tpu_torch.cli import (build_demo_sequences,
                                               demo_config, run_align)
    seqs, gt, _, moved = build_demo_sequences("cpu", n_frames=5,
                                              arc_center_deg=45.0 / 4 / 2)
    names = []

    def stage(name, fn):
        names.append(name)
        return fn()
    res, pts, _, verts, faces = run_align(seqs, demo_config(), 32,
                                          str(tmp_path), stage)
    assert names == ["prep_s", "sweep_solve_s", "fuse_s", "tsdf_s",
                     "trim_write_s"]
    T = res.transforms[0]
    _check_gt(float(T.s), T.R.numpy(), T.t.numpy(), gt)
    assert res.residuals[0] > 0 and res.keyframes[0] != (0, 0)
    assert _rmse_to(pts, moved.vertices) < 0.05
    assert len(verts) > 0 and len(faces) > 0
    for f in ("SRT.txt", "PSR.npts", "Model.obj"):
        assert (tmp_path / f).stat().st_size > 0, f


def test_cli_align_demo_writes_results(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-m", "multiviewstitch_tpu_torch.cli", "align",
         "--demo", "--device", "cpu", "--grid", "48", "--workdir",
         str(tmp_path)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    res = tmp_path / "Result"
    for f in ("SRT.txt", "PSR.npts", "Model.obj"):
        assert (res / f).stat().st_size > 0, f
    Ts = load_srt(str(res / "SRT.txt"))
    assert len(Ts) == 2
    assert abs(float(Ts[0].s) - 1.25) < 0.1
    assert float(Ts[1].s) == 1.0
    assert "jax" not in proc.stdout + proc.stderr


@pytest.mark.parametrize("extra", [
    ["--backend", "poisson"], ["--write-mesh"], ["--config"],
    ["--set", "all_seq_proj=true"], ["--set", "segment=1"]])
def test_cli_runs_the_paths_ported_since(tmp_path, extra, capsys):
    """Each path the CLI used to refuse, on the demo inputs (--config: the
    demo sequences written in the reference's layout)."""
    from multiviewstitch_tpu_torch.cli import (build_demo_sequences, main,
                                               run_align)
    from multiviewstitch_tpu_torch.pipeline.ingest import save_sequence_dir
    wd = tmp_path / "work"
    args = ["align", "--device", "cpu", "--workdir", str(wd), "--grid", "32",
            "--set", "psn_dpt_max=5"]
    if extra == ["--config"]:
        seqs, *_ = build_demo_sequences("cpu")
        for k, seq in enumerate(seqs):
            save_sequence_dir(str(tmp_path / f"s{k}"), seq)
        (tmp_path / "imgPathList.txt").write_text("./s0/\n./s1/\n")
        (tmp_path / "config.txt").write_text(
            "ImgPathList ./imgPathList.txt\nViewCount 1\nMinMatchCount 7\n"
            "IterNum 256\nSampleIterval 4\nSSDWin 3\nSSDError 40.0\n"
            "PixelError 12.0\nHLMarginRatio 0.02\nHRMarginRatio 0.02\n"
            "VLMarginRatio 0.02\nVRMarginRatio 0.02\nMinDsp 0.001\n"
            "MaxDsp 10.0\nNbrFrmNum 1\nMinConf 0.5\nMaxDspErr 0.05\n")
        extra = ["--config", str(tmp_path / "config.txt"), "--set",
                 "max_keypoints=256"]
    else:
        args.append("--demo")
    stages = []
    assert main(args + extra,
                stage=lambda n, fn: stages.append(n) or fn()) == 0
    assert "not ported" not in capsys.readouterr().out
    for f in ("SRT.txt", "PSR.npts", "Model.obj"):
        assert (wd / "Result" / f).stat().st_size > 0, f
    Ts = load_srt(str(wd / "Result" / "SRT.txt"))
    assert abs(float(Ts[0].s) - 1.25) < 0.1
    new_stage = {"--backend": "poisson_s", "--write-mesh": "write_mesh_s",
                 "--config": "ingest_s", "--set": None}[extra[0]]
    if extra[1:2] == ["all_seq_proj=true"]:
        new_stage = "all_seq_proj_s"
    if new_stage:
        assert new_stage in stages
    assert ("tsdf_s" in stages) == (extra[:2] != ["--backend", "poisson"])
    models = wd / "Models"
    assert (len(os.listdir(models)) == 10) if extra == ["--write-mesh"] \
        else not models.exists()


@pytest.mark.parametrize("cmd", ["align", "pipeline"])
@pytest.mark.parametrize("extra", [
    ["--refine"], ["--refine", "ba"], ["--debug-artifacts"]])
def test_cli_refuses_paths_not_ported(tmp_path, extra, capsys, cmd):
    """The paths this test used to see refused now run: the pose graph
    (refine_s), bundle adjustment (refine_s) and the match dumps
    (<workdir>/Match), in align and in pipeline."""
    from multiviewstitch_tpu_torch.cli import main
    args = [cmd, "--device", "cpu", "--workdir", str(tmp_path), "--demo",
            "--grid", "32"] + (["--passes", "1"] if cmd == "pipeline" else [])
    stages = []
    assert main(args + extra,
                stage=lambda n, fn: stages.append(n) or fn()) == 0
    out = capsys.readouterr().out
    assert "not ported" not in out
    Ts = load_srt(str(tmp_path / "Result" / "SRT.txt"))
    assert abs(float(Ts[0].s) - 1.25) < 0.1
    assert ("refine_s" in stages) == (extra[0] == "--refine")
    if extra[0] == "--refine":
        key = "ba_rmse_px" if extra[1:] else "pose_graph_rmse"
        assert key in out
    match = tmp_path / "Match"
    assert (len(os.listdir(match)) == 1) if extra == ["--debug-artifacts"] \
        else not match.exists()
    assert (tmp_path / "Result" / "deform.obj").exists() == \
        (cmd == "pipeline")


def test_cli_refine_invalidates_the_align_manifest(tmp_path, capsys):
    """A --refine ba run after a plain run recomputes (the manifest hash
    covers --refine, as the JAX CLI's does); a repeat of it skips."""
    from multiviewstitch_tpu_torch.cli import main
    args = ["align", "--device", "cpu", "--workdir", str(tmp_path), "--demo",
            "--grid", "32"]
    runs = []
    for extra in ([], [], ["--refine", "ba"], ["--refine", "ba"]):
        stages = []
        assert main(args + extra,
                    stage=lambda n, fn: stages.append(n) or fn()) == 0
        runs.append((stages, "up to date" in capsys.readouterr().out))
    assert runs[0][0] and not runs[0][1]
    assert runs[1] == ([], True)
    assert "refine_s" in runs[2][0] and not runs[2][1]
    assert runs[3] == ([], True)


@pytest.mark.parametrize("cmd", ["bench"])
def test_cli_refuses_other_commands(cmd, capsys):
    from multiviewstitch_tpu_torch.cli import main
    assert main([cmd, "--demo"]) == 2
    assert "not ported" in capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["deform", "render", "pipeline"])
def test_cli_runs_the_mode_two_commands(tmp_path, cmd, capsys):
    """The commands the CLI used to refuse: deform --demo, render on its
    deform.obj, and the whole pipeline --demo."""
    from multiviewstitch_tpu_torch.cli import main
    args = ["--device", "cpu", "--workdir", str(tmp_path)]
    if cmd == "render":
        assert main(["deform", "--demo", "--passes", "1"] + args) == 0
    extra = {"deform": ["--demo", "--passes", "1"], "render": [],
             "pipeline": ["--demo", "--grid", "32", "--passes", "1"]}[cmd]
    assert main([cmd] + extra + args) == 0
    assert "not ported" not in capsys.readouterr().out
    assert (tmp_path / "Result" / "deform.obj").stat().st_size > 0
    assert (tmp_path / "Result" / "SRT.txt").exists() == (cmd == "pipeline")
    raws = tmp_path / "DATA" / "Render"
    assert (len(os.listdir(raws)) == 8) if cmd != "deform" \
        else not raws.exists()


def test_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from multiviewstitch_tpu_torch.cli import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["align", "--demo", "--workdir", str(tmp_path)])
