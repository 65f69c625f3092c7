"""The slice end to end on the reference's on-disk layout: the JAX
package's ``cmd_align`` and the port's CLI, both on the CPU, on one
directory of two 3-frame 96x72 sequences (tests/test_ingest.py's size) with
``--backend poisson --set psn_dpt_max=6 --write-mesh``, ``segment`` and
``all_seq_proj``.

Bounds: both recover the ground truth within tests/test_e2e_align.py's
bounds (s 5 %, rotation 3 deg, translation 0.08) and agree within
tests/test_torch_align_slice.py's (s 2 %, rotation 1.5 deg; RANSAC draws
differ); fused point counts within 10 %; the per-frame meshes equal (faces
exact, vertices atol 1e-6: the same disparities); the Poisson meshes'
vertex counts within 5 % and their symmetric chamfer distance under half
a voxel (the fused clouds differ where the RANSAC draws do)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multiviewstitch_tpu import cli as jcli
from multiviewstitch_tpu.pipeline.ingest import save_sequence_dir
from multiviewstitch_tpu_torch import cli as tcli
from multiviewstitch_tpu_torch.core.transforms import rotation_angle_deg
from multiviewstitch_tpu_torch.io.meshio import read_npts, read_obj
from multiviewstitch_tpu_torch.io.srt import load_srt
from test_e2e_align import build_two_sequences

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_e2e_align.py's CFG as a legacy config.txt (max_keypoints has
# no legacy key: --set)
CONFIG = """# two demo sequences in the reference's layout
ImgPathList ./imgPathList.txt
ViewCount 1 MinMatchCount 7 IterNum 256 SampleIterval 4 SSDWin 3
SSDError 40.0 ReprojError 4 PixelError 12.0 AdtPxlErrRatio 0.6
DistMax 0.7 RatioMax 0.8
HLMarginRatio 0.02 HRMarginRatio 0.02 VLMarginRatio 0.02 VRMarginRatio 0.02
MinDsp 0.001 MaxDsp 10.0 NbrFrmNum 1 MinConf 0.5 MaxDspErr 0.05
"""
FLAGS = ["--backend", "poisson", "--write-mesh", "--set", "segment=true",
         "--set", "all_seq_proj=true", "--set", "psn_dpt_max=6", "--set",
         "max_keypoints=256"]


def write_layout(root, seqs):
    """save_sequence_dir of each sequence + imgPathList.txt + config.txt;
    returns the config path."""
    for k, s in enumerate(seqs):
        save_sequence_dir(os.path.join(root, f"seq{k}"), s)
    with open(os.path.join(root, "imgPathList.txt"), "w") as f:
        f.write("".join(f"./seq{k}/\n" for k in range(len(seqs))))
    path = os.path.join(root, "config.txt")
    with open(path, "w") as f:
        f.write(CONFIG)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("layout")
    seq1, seq2, gt, _, moved = build_two_sequences(n_frames=3, width=96,
                                                   height=72)
    config = write_layout(str(root), [seq1, seq2])
    jwd, twd = str(root / "jax"), str(root / "port")
    assert jcli.main(["align", "--config", config, "--workdir", jwd] +
                     FLAGS) == 0
    stages = []
    assert tcli.main(["align", "--config", config, "--workdir", twd,
                      "--device", "cpu"] + FLAGS,
                     stage=lambda n, fn: stages.append(n) or fn()) == 0
    return dict(config=config, jwd=jwd, twd=twd, gt=gt, moved=moved,
                stages=stages)


def _result(wd, name):
    return os.path.join(wd, "Result", name)


def _check_gt(T, gt):
    assert abs(float(T.s) - float(gt.s)) <= 0.05 * float(gt.s)
    assert rotation_angle_deg(T.R, np.asarray(gt.R)) < 3.0
    assert np.linalg.norm(T.t.numpy() - np.asarray(gt.t)) < 0.08


def test_stages_run_in_order(runs):
    assert runs["stages"] == ["ingest_s", "prep_s", "sweep_solve_s",
                              "fuse_s", "write_mesh_s", "poisson_s",
                              "all_seq_proj_s", "trim_write_s"]


def test_both_recover_gt_and_agree(runs):
    jT = load_srt(_result(runs["jwd"], "SRT.txt"))
    tT = load_srt(_result(runs["twd"], "SRT.txt"))
    assert len(jT) == len(tT) == 2
    _check_gt(jT[0], runs["gt"])
    _check_gt(tT[0], runs["gt"])
    assert abs(float(tT[0].s) - float(jT[0].s)) <= 0.02 * float(jT[0].s)
    assert rotation_angle_deg(tT[0].R, jT[0].R) < 1.5
    assert float(tT[1].s) == 1.0


def test_fused_clouds_agree(runs):
    jp, _ = read_npts(_result(runs["jwd"], "PSR.npts"))
    tp, tn = read_npts(_result(runs["twd"], "PSR.npts"))
    print(f"PSR.npts: jax {len(jp)}, port {len(tp)}")
    assert len(tp) > 1000 and abs(len(tp) - len(jp)) <= 0.1 * len(jp)
    assert np.isfinite(tp).all() and np.isfinite(tn).all()


def test_per_frame_meshes_equal(runs):
    jdir = os.path.join(runs["jwd"], "Models")
    tdir = os.path.join(runs["twd"], "Models")
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) == sorted(
        f"model{k}_{i}.obj" for k in range(2) for i in range(3))
    for n in names:
        tv, _, tf = read_obj(os.path.join(tdir, n))
        jv, _, jf = read_obj(os.path.join(jdir, n))
        assert len(tf) > 100
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, atol=1e-6, rtol=0)


def _chamfer(a, b):
    def one(p, q):
        return np.concatenate([
            np.sqrt(((p[c:c + 1024, None] - q[None]) ** 2).sum(-1).min(1))
            for c in range(0, len(p), 1024)]).mean()
    return 0.5 * (one(a, b) + one(b, a))


def test_poisson_models_agree_and_match_the_surface(runs):
    jv, _, jf = read_obj(_result(runs["jwd"], "Model.obj"))
    tv, _, tf = read_obj(_result(runs["twd"], "Model.obj"))
    pts, _ = read_npts(_result(runs["twd"], "PSR.npts"))
    voxel = float((pts.max(0) - pts.min(0)).max()) * 1.2 / 63
    ch = _chamfer(tv, jv)
    print(f"Model.obj: jax {len(jv)}/{len(jf)}, port {len(tv)}/{len(tf)}, "
          f"chamfer {ch / voxel:.4f} voxel")
    assert len(tv) > 500 and abs(len(tv) - len(jv)) <= 0.05 * len(jv)
    assert ch < 0.5 * voxel
    assert tf.min() >= 0 and tf.max() < len(tv)


def test_second_run_skips_and_write_mesh_recomputes(runs, capsys):
    """The manifest hash covers --write-mesh, as the JAX CLI's does."""
    wd = os.path.join(os.path.dirname(runs["config"]), "rerun")
    base = ["align", "--config", runs["config"], "--workdir", wd,
            "--device", "cpu", "--backend", "poisson", "--set",
            "psn_dpt_max=5", "--set", "max_keypoints=256"]
    assert tcli.main(base) == 0
    capsys.readouterr()
    assert tcli.main(base) == 0
    assert "up to date" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(wd, "Models"))
    assert tcli.main(base + ["--write-mesh"]) == 0
    assert "up to date" not in capsys.readouterr().out
    assert len(os.listdir(os.path.join(wd, "Models"))) == 6
    assert tcli.main(base + ["--write-mesh"]) == 0
    assert "up to date" in capsys.readouterr().out


def test_poisson_depth_is_capped_at_10(monkeypatch, capsys, tmp_path):
    from multiviewstitch_tpu_torch.ops import poisson
    seen = []

    def fake(pts, nrm, *, depth, device):
        seen.append(depth)
        v = np.eye(3, dtype=np.float32)
        return v, np.asarray([[0, 1, 2]], np.int32)
    monkeypatch.setattr(poisson, "reconstruct_poisson", fake)
    seqs, *_ = tcli.build_demo_sequences("cpu", n_frames=3, width=96,
                                         height=72)
    cfg = tcli.demo_config()
    for d in (11, 7):
        tcli.run_align(seqs, cfg.replace(psn_dpt_max=d), 32, str(tmp_path),
                       backend="poisson")
    assert seen == [10, 7]
    out = capsys.readouterr().out
    assert out.count("Poisson depth capped at 10 (PsnDptMax 11)") == 1


def test_cli_module_runs_config_on_cpu(runs, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-m", "multiviewstitch_tpu_torch.cli", "align",
         "--config", runs["config"], "--workdir", str(tmp_path),
         "--device", "cpu"] + FLAGS, cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for f in ("SRT.txt", "PSR.npts", "Model.obj"):
        assert (tmp_path / "Result" / f).stat().st_size > 0, f
    assert len(os.listdir(tmp_path / "Models")) == 6
    assert "AllSeqProj trim" in proc.stdout
    assert "jax" not in proc.stdout + proc.stderr
