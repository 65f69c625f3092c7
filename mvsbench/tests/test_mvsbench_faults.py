"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have (the exchange between chips cannot: every
cell is on one chip), and the lower-precision control fails the
committed limits of the numbers it moves. On the CPU at a small size:
the run's look for a card is skipped, and the limits are set from a sound
run at that size. The body scan's stages (fit, re-render) have no cell
yet; a small body job, described here, holds their faults."""

import json
import math

import pytest
import torch

from mvsbench import calibrate, harness, judge, spec

CPU = torch.device("cpu")
BENCH = spec.benchmark()
BODY = "body_scan.small"
BODY_CONFIG = {
    "command": ["pipeline", "--refine", "ba"],
    "settings": {"ViewCount": 1, "MinMatchCount": 7, "IterNum": 256,
                 "SampleIterval": 4, "SSDWin": 3, "SSDError": 40.0,
                 "ReprojError": 4, "PixelError": 12.0, "AdtPxlErrRatio": 0.6,
                 "HLMarginRatio": 0.02, "HRMarginRatio": 0.02,
                 "VLMarginRatio": 0.02, "VRMarginRatio": 0.02,
                 "MinDsp": 0.001, "MaxDsp": 10.0, "PtSampRds": 2,
                 "NbrFrmNum": 1, "NbrFrmStep": 1, "MinConf": 0.5,
                 "MaxDspErr": 0.05, "PsnDptMax": 6},   # a TSDF grid of 64
    "set": {"max_keypoints": 512},
    "final_surface": "deform.obj", "render": True}
BODY_TRAFFIC = {
    "scene": "posed_body", "frames": 12, "width": 480, "height": 640,
    "cam_radius": 2.8, "frame_fill": 0.25, "arm_deg": 15.0, "leg_deg": 5.0,
    "ring_offset_deg": 0.0, "scale": 1.12, "yaw_deg": 9.0,
    "translation": [0.12, -0.06, 0.1]}
CELLS = ("scan_vga.seq2x16", BODY)


def small(name):
    if name == BODY:
        return spec.Cell(BODY, 1, BODY_CONFIG, BODY_TRAFFIC, {})
    cell = spec.cell(name, BENCH)
    t, cfg = dict(cell.traffic), json.loads(json.dumps(cell.config))
    t.update(frames=5, width=160, height=120, focal=131.25)
    cfg["settings"]["PsnDptMax"] = 6
    cfg["set"]["max_keypoints"] = 256
    return cell._replace(traffic=t, config=cfg)


def run_line(cell, seed, monkeypatch, fault=None):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    ctx = calibrate.faults_for(cell)[fault]() if fault else None
    if ctx is not None:
        with ctx:
            run = harness.run_cell(cell, seed, 1e-3, False, CPU, 0.0)
    else:
        run = harness.run_cell(cell, seed, 1e-3, False, CPU, 0.0)
    try:
        return run, harness.report(run, BENCH, False, 1)
    finally:
        run.close()


def limits_from(run):
    """Room above a sound run's numbers at this size (exact ones stay 0)."""
    nums = judge.worst(run.judged)
    return {k: (0.0 if k == "extra_components" else 3 * v + 1e-9)
            for k, v in nums.items()}


@pytest.fixture(scope="module")
def sound_limits():
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name in CELLS:
            cell = small(name)
            run, _ = run_line(cell, 2 ** 31 + 21, mp)
            out[name] = limits_from(run)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name,fault", [
    ("scan_vga.seq2x16", "state_unchanged"),
    ("scan_vga.seq2x16", "half_batch"),
    ("scan_vga.seq2x16", "points_altered"),
    ("scan_vga.seq2x16", "poisson_unchanged"),
    (BODY, "fit_unchanged"),
    (BODY, "raster_altered"),
])
def test_fault_is_not_correct(name, fault, sound_limits, monkeypatch):
    cell = small(name)._replace(limits=sound_limits[name])
    _, sound = run_line(cell, 2 ** 31 + 21, monkeypatch)
    assert sound["correct"] is True, sound["checks"]
    try:
        _, line = run_line(cell, 2 ** 31 + 21, monkeypatch, fault)
    except RuntimeError as e:       # the fault fails the warm-up job: no
        assert "warm-up" in str(e)  # result at all
        return
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items()
              if not (isinstance(c["value"], float) and
                      c["value"] <= c["limit"])]
    assert failed, line["checks"]


def test_every_fault_a_cell_can_have_is_tested():
    tested = {"state_unchanged", "half_batch", "points_altered",
              "poisson_unchanged", "fit_unchanged", "raster_altered"}
    for name in CELLS:
        assert set(calibrate.faults_for(small(name))) <= tested


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_the_committed_limits(name, tmp_path):
    cell = small(name)
    committed = spec.cell(name, BENCH).limits
    scene = spec.scene(cell.traffic["scene"]).generate(cell.traffic,
                                                       2 ** 31 + 33, CPU)
    runner = harness.Runner(cell, scene, str(tmp_path), CPU)
    job = runner.job()
    j = judge.Judge(scene, cell.config, CPU)
    sound = j.job(job.workdir, runner.render_dirs())
    ctl = calibrate.control_numbers(runner, j, sound, job.workdir)
    moved = [k for k in ("cloud_gap", "normal_gap", "render_gap",
                         "render_mismatch") if k in ctl]
    assert moved
    assert any(ctl[k] > committed.get(k, math.inf) for k in moved), ctl
    assert all(sound[k] <= committed.get(k, -math.inf) for k in moved)
