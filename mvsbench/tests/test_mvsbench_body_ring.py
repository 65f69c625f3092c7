"""The body cell ``body_scan.ring2x48`` on the CPU: its noisy ring scene is
seeded and, without noise, is ``posed_body``'s scene; the cell, shrunk, runs
``correct`` through ``harness.run_cell`` and each of its body faults comes
out not correct at limits taken from a sound run.

The cell is shrunk to 2 x 16 frames at 240x320 (the focal length halved
with the frame), not as ``test_mvsbench_faults.small`` shrinks cells: five
frames on a full ring are 72 degrees apart, so the fuse's multi-frame
agreement (NbrFrmNum 5, MinConf 0.6) keeps no point, and at 160x120 the
24-pixel match spacing (SampleIterval's default) leaves at most 4 matches
on an edge for most seeds, below MinMatchCount."""

import json
import math

import numpy as np
import pytest
import torch

from mvsbench import calibrate, harness, judge, spec
from mvsbench.scenes import posed_body, posed_body_noisy

CPU = torch.device("cpu")
BENCH = spec.benchmark()
CELL = "body_scan.ring2x48"
SEED = 2 ** 31 + 21


def shrunk():
    cell = spec.cell(CELL, BENCH)
    t, cfg = dict(cell.traffic), json.loads(json.dumps(cell.config))
    t.update(frames=16, width=240, height=320, focal=t["focal"] / 2)
    cfg["settings"]["PsnDptMax"] = 6
    cfg["set"]["max_keypoints"] = 256
    return cell._replace(traffic=t, config=cfg)


def tiny_traffic(**kw):
    t = dict(spec.cell(CELL, BENCH).traffic)
    t.update(frames=3, width=30, height=40, focal=33.0, **kw)
    return t


def test_the_noisy_ring_is_seeded_and_sized_alike():
    t = tiny_traffic()
    a = posed_body_noisy.generate(t, SEED, CPU)
    b = posed_body_noisy.generate(t, SEED, CPU)
    c = posed_body_noisy.generate(t, 11, CPU)
    assert a.frames == 6 and len(a.gt) == 2
    for x, y in zip(a.sequences, b.sequences):
        torch.testing.assert_close(x.gray, y.gray, rtol=0, atol=0)
        torch.testing.assert_close(x.disparity, y.disparity, rtol=0, atol=0)
        torch.testing.assert_close(x.cams.R, y.cams.R, rtol=0, atol=0)
    assert not torch.equal(a.sequences[1].disparity,
                           c.sequences[1].disparity)
    for x, y in zip(a.sequences, c.sequences):
        assert x.gray.shape == y.gray.shape == (3, 40, 30)
    # the second ring is the first, turned, in the moved world
    assert a.gt[0].s == pytest.approx(1.12)
    assert a.truth_faces.shape == c.truth_faces.shape


def test_without_noise_it_is_the_posed_body_scene():
    t = tiny_traffic(noise=0.0)
    fill = t["focal"] * posed_body.BODY_HEIGHT / (t["height"] *
                                                  t["cam_radius"])
    t["focal"] = float(fill * t["height"] * t["cam_radius"] /
                       posed_body.BODY_HEIGHT)
    plain = dict(t, frame_fill=fill)
    a = posed_body_noisy.generate(t, SEED, CPU)
    b = posed_body.generate(plain, SEED, CPU)
    for x, y in zip(a.sequences, b.sequences):
        for u, v in ((x.gray, y.gray), (x.disparity, y.disparity),
                     (x.cams.K, y.cams.K), (x.cams.R, y.cams.R),
                     (x.cams.t, y.cams.t)):
            torch.testing.assert_close(u, v, rtol=0, atol=0)
    np.testing.assert_array_equal(a.truth_vertices, b.truth_vertices)
    np.testing.assert_array_equal(a.truth_faces, b.truth_faces)
    for g, h in zip(a.gt, b.gt):
        assert g.s == h.s
        np.testing.assert_array_equal(g.R, h.R)
        np.testing.assert_array_equal(g.t, h.t)


def run_line(cell, monkeypatch, fault=None):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    ctx = calibrate.faults_for(cell)[fault]() if fault else None
    if ctx is not None:
        with ctx:
            run = harness.run_cell(cell, SEED, 1e-3, False, CPU, 0.0)
    else:
        run = harness.run_cell(cell, SEED, 1e-3, False, CPU, 0.0)
    try:
        return run, harness.report(run, BENCH, False, 1)
    finally:
        run.close()


@pytest.fixture(scope="module")
def sound_limits():
    """Room above a sound run's numbers (exact ones stay 0), as
    ``test_mvsbench_faults.limits_from`` gives it."""
    mp = pytest.MonkeyPatch()
    try:
        run, _ = run_line(shrunk(), mp)
    finally:
        mp.undo()
    nums = judge.worst(run.judged)
    return {k: (0.0 if k == "extra_components" else 3 * v + 1e-9)
            for k, v in nums.items()}


def test_the_shrunk_cell_runs_correct(sound_limits, monkeypatch):
    cell = shrunk()._replace(limits=sound_limits)
    run, line = run_line(cell, monkeypatch)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and len(run.done) >= 1
    nums = judge.worst(run.judged)
    # the fused cloud is not empty and the fit and the re-render are judged
    for k in ("cloud_gap", "fit_rms", "render_mismatch", "render_gap"):
        assert math.isfinite(nums[k]), k
    assert set(calibrate.faults_for(cell)) == {
        "state_unchanged", "half_batch", "points_altered", "fit_unchanged",
        "raster_altered"}


@pytest.mark.parametrize("fault", ["fit_unchanged", "raster_altered",
                                   "state_unchanged"])
def test_a_body_fault_is_not_correct(fault, sound_limits, monkeypatch):
    cell = shrunk()._replace(limits=sound_limits)
    _, line = run_line(cell, monkeypatch, fault)
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items()
              if not (isinstance(c["value"], float) and
                      c["value"] <= c["limit"])]
    assert failed, line["checks"]


def test_a_port_without_the_ba_outlier_drop_is_refused(monkeypatch):
    """The cell stops before its first job, with no work directory made,
    where the port's BA would solve on every observation."""
    from multiviewstitch_tpu_torch.pipeline import ba_refine
    monkeypatch.delattr(ba_refine, "drop_outliers")
    with pytest.raises(RuntimeError, match="drop_outliers"):
        posed_body_noisy.generate(tiny_traffic(), SEED, CPU)
    made = []
    monkeypatch.setattr(harness.tempfile, "mkdtemp",
                        lambda **kw: made.append(kw) or "/nonexistent")
    with pytest.raises(RuntimeError, match="outlier drop"):
        harness.run_cell(shrunk(), SEED, 1e-3, False, CPU, 0.0)
    assert made == []
