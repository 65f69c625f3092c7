"""The port's debug switches and utils: check_finite, run_stage, the CLI's
MVS_DEBUG_NUMERICS=1 stage checks, the --debug-artifacts /
debug_artifacts match dumps, and utils/metrics against the JAX package's
copy (equal values)."""

import os

import numpy as np
import pytest
import torch

from multiviewstitch_tpu.utils import metrics as jmetrics
from multiviewstitch_tpu_torch.utils import debug_mode, metrics

torch.set_num_threads(2)

ALIGN = ["align", "--demo", "--device", "cpu", "--grid", "32"]


def test_check_finite_names_the_offender():
    ok = np.ones((4, 3), np.float32)
    debug_mode.check_finite("fuse", points=ok, normals=torch.ones(4, 3))
    bad = torch.ones(4, 3)
    bad[1, 2] = float("nan")
    bad[3, 0] = float("inf")
    with pytest.raises(FloatingPointError,
                       match=r"stage 'fuse': array 'normals' has 2/12"):
        debug_mode.check_finite("fuse", points=ok, normals=bad)
    with pytest.raises(FloatingPointError, match="array 'R0'"):
        debug_mode.check_finite("align", R0=bad.numpy())


def test_run_stage_retries_transient_and_reraises_real_errors():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("UNAVAILABLE: device reset")
        return "done"
    assert debug_mode.run_stage(flaky, stage="t", backoff_s=0.0) == "done"
    assert len(calls) == 3

    def broken():
        calls.append(1)
        raise ValueError("shape mismatch")
    calls.clear()
    with pytest.raises(ValueError):
        debug_mode.run_stage(broken, backoff_s=0.0)
    assert len(calls) == 1

    def always():
        raise RuntimeError("RESOURCE_EXHAUSTED")
    with pytest.raises(RuntimeError):
        debug_mode.run_stage(always, retries=1, backoff_s=0.0)


def test_debug_numerics_checks_the_fused_cloud(tmp_path, monkeypatch):
    from multiviewstitch_tpu_torch.cli import main
    from multiviewstitch_tpu_torch.pipeline import align_seq
    real = align_seq.fuse_sequences

    def nan_cloud(*a, **k):
        pts, nrm = real(*a, **k)
        pts[7, 1] = np.nan
        return pts, nrm
    monkeypatch.setattr(align_seq, "fuse_sequences", nan_cloud)
    monkeypatch.setenv("MVS_DEBUG_NUMERICS", "1")
    with pytest.raises(FloatingPointError,
                       match="stage 'fuse': array 'points' has 1/"):
        main(ALIGN + ["--workdir", str(tmp_path)])
    assert not (tmp_path / "Result" / "Model.obj").exists()


@pytest.mark.parametrize("switch", ["1", None])
def test_debug_numerics_checks_the_mesh_only_under_the_switch(
        tmp_path, monkeypatch, switch):
    from multiviewstitch_tpu_torch.cli import main
    from multiviewstitch_tpu_torch.ops import tsdf
    real = tsdf.fuse_multi_sequence

    def nan_mesh(*a, **k):
        v, f, t = real(*a, **k)
        v[0, 0] = np.inf
        return v, f, t
    monkeypatch.setattr(tsdf, "fuse_multi_sequence", nan_mesh)
    if switch:
        monkeypatch.setenv("MVS_DEBUG_NUMERICS", switch)
        with pytest.raises(FloatingPointError,
                           match="stage 'reconstruct': array 'vertices'"):
            main(ALIGN + ["--workdir", str(tmp_path)])
    else:
        monkeypatch.delenv("MVS_DEBUG_NUMERICS", raising=False)
        assert main(ALIGN + ["--workdir", str(tmp_path)]) == 0


def _pngs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


def test_debug_artifacts_flag_writes_the_match_dump(tmp_path):
    from PIL import Image
    from multiviewstitch_tpu_torch.cli import main
    assert main(ALIGN + ["--workdir", str(tmp_path),
                         "--debug-artifacts"]) == 0
    pngs = _pngs(tmp_path / "Match")
    assert len(pngs) == 1 and pngs[0].startswith("match0_"), pngs
    img = np.asarray(Image.open(tmp_path / "Match" / pngs[0]))
    assert img.shape == (96, 256, 3) and img.std() > 10


def test_debug_artifacts_config_writes_into_cwd_match(tmp_path, monkeypatch):
    """cfg.debug_artifacts without a directory dumps into ./Match, as the
    JAX package does."""
    from multiviewstitch_tpu_torch.cli import main
    monkeypatch.chdir(tmp_path)
    assert main(ALIGN + ["--workdir", "work", "--set",
                         "debug_artifacts=true"]) == 0
    assert len(_pngs(tmp_path / "Match")) == 1
    assert not (tmp_path / "work" / "Match").exists()


def test_metrics_equal_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    surf = rng.normal(size=(500, 3)).astype(np.float32)
    assert metrics.point_to_surface_rmse(pts, surf, chunk=64) == \
        jmetrics.point_to_surface_rmse(pts, surf, chunk=64)
    est = rng.normal(size=(12, 3))
    gt = 1.3 * est @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.2 + \
        rng.normal(size=(12, 3)) * 0.01
    assert metrics.trajectory_ate(est, gt) == jmetrics.trajectory_ate(est, gt)
    assert metrics.trajectory_ate(est, gt) < 0.05
