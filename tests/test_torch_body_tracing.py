"""The body scanner's spans and counters (utils/profiling.py) on the CPU: one
tiny ``pipeline --config --refine ba --backend tsdf`` job (two rings of 6
portrait 120x160 frames around the posed template body, the second ring's
world moved by a similarity) recorded, and the same job with recording
off. Each span of BA, the TSDF, the template fit and the re-render nests
under its ``stage.*``; the counters read the sizes the inputs imply; with
recording off nothing is recorded; the outputs are the same bytes either
way."""

import os

import numpy as np
import pytest
import torch

from multiviewstitch_tpu_torch.core.transforms import Similarity
from multiviewstitch_tpu_torch.models.template_body import (make_template,
                                                            pose_template)
from multiviewstitch_tpu_torch.pipeline.align_seq import Sequence
from multiviewstitch_tpu_torch.pipeline.fixtures import (mesh_scene,
                                                         ring_cameras,
                                                         textured_views)
from multiviewstitch_tpu_torch.pipeline.ingest import save_sequence_dir
from multiviewstitch_tpu_torch.utils import profiling

torch.set_num_threads(2)

FRAMES, WIDTH, HEIGHT = 6, 120, 160
# the demo's knobs (cli.demo_config) as a legacy config.txt; PsnDptMax 6
# gives a TSDF grid of 64
CONFIG = """# two rings around a posed body
ImgPathList ./imgPathList.txt
ViewCount 1 MinMatchCount 7 IterNum 64 SampleIterval 4 SSDWin 3
SSDError 40.0 ReprojError 4 PixelError 12.0 AdtPxlErrRatio 0.6
HLMarginRatio 0.02 HRMarginRatio 0.02 VLMarginRatio 0.02 VRMarginRatio 0.02
MinDsp 0.001 MaxDsp 10.0 NbrFrmNum 1 MinConf 0.5 MaxDspErr 0.05
PsnDptMax 6
"""
# each new span and the stage it runs in (directly or below a nested one;
# ``stage.deform_pass`` is either pass's)
SPAN_STAGES = {
    "ba.build": "stage.refine", "ba.solve": "stage.refine",
    "ba.refit": "stage.refine",
    "tsdf.fuse": "stage.tsdf", "tsdf.extract": "stage.tsdf",
    "deform.remove_ground": "stage.deform_align",
    "deform.init_alignment": "stage.deform_align",
    "deform.part_recog": "stage.deform_align",
    "deform.local_alignment": "stage.deform_align",
    "deform.normals": "stage.deform", "deform.setup": "stage.deform",
    "deform.correspondences": "stage.deform_pass",
    "deform.arap": "stage.deform_pass",
    "render.raster": "stage.render", "render.write": "stage.render",
}


def _write_layout(root):
    tv, tf, tl = make_template()
    body = pose_template(tv, tl, 15.0, 5.0).astype(np.float32)
    center = body.mean(0)
    cams = ring_cameras(FRAMES, radius=2.4, height=float(center[1]),
                        width=WIDTH, length_focal=200.0, img_height=HEIGHT,
                        look_at=tuple(center.tolist()), device="cpu")
    R = np.array([[0.98768834, 0.0, 0.15643447], [0.0, 1.0, 0.0],
                  [-0.15643447, 0.0, 0.98768834]], np.float32)
    gt = Similarity(torch.tensor(1.12), torch.as_tensor(R),
                    torch.tensor([0.12, -0.06, 0.1]))
    for k, T in enumerate((None, gt)):
        scene = mesh_scene(body, tf, cams, T)
        seq = Sequence(textured_views(scene), scene.disparity, scene.cams)
        save_sequence_dir(os.path.join(root, f"seq{k}"), seq)
    with open(os.path.join(root, "imgPathList.txt"), "w") as f:
        f.write("./seq0/\n./seq1/\n")
    path = os.path.join(root, "config.txt")
    with open(path, "w") as f:
        f.write(CONFIG)
    return path


def _argv(config, workdir):
    return ["pipeline", "--config", config, "--workdir", workdir,
            "--device", "cpu", "--refine", "ba", "--backend", "tsdf",
            "--set", "max_keypoints=256", "--force"]


def _outputs(config, workdir):
    """Result/'s files and every re-rendered raster, as bytes."""
    out = {}
    res = os.path.join(workdir, "Result")
    for name in sorted(os.listdir(res)):
        with open(os.path.join(res, name), "rb") as f:
            out[name] = f.read()
    base = os.path.dirname(config)
    for k in range(2):
        rdir = os.path.join(base, f"seq{k}", "DATA", "Render")
        for name in sorted(os.listdir(rdir)):
            with open(os.path.join(rdir, name), "rb") as f:
                out[f"seq{k}/{name}"] = f.read()
    return out


@pytest.fixture(scope="module")
def body_jobs(tmp_path_factory):
    """The job recorded, then with recording off under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from multiviewstitch_tpu_torch.cli import main
    root = tmp_path_factory.mktemp("body")
    config = _write_layout(str(root))
    with profiling.recording() as rec:
        assert main(_argv(config, str(root / "on"))) == 0
    recorded = _outputs(config, str(root / "on"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert main(_argv(config, str(root / "off"))) == 0
    plain = _outputs(config, str(root / "off"))
    ranges = [e.name for e in prof.events()
              if e.name.startswith(profiling.RANGE_PREFIX)]
    return rec, recorded, plain, ranges


def _ancestors(job, span):
    by_id = {s.id: s for s in job.spans}
    out = []
    while span.parent is not None:
        span = by_id[span.parent]
        out.append(span.name)
    return out


def test_each_new_span_nests_under_its_stage(body_jobs):
    rec, _, _, _ = body_jobs
    (job,) = rec.jobs()
    names = {s.name for s in job.spans}
    assert set(SPAN_STAGES) <= names, set(SPAN_STAGES) - names
    for s in job.spans:
        if s.name in SPAN_STAGES:
            assert any(a.startswith(SPAN_STAGES[s.name])
                       for a in _ancestors(job, s)), s.name
    # one raster and one write a sequence; the fit's two passes
    assert sum(s.name == "render.raster" for s in job.spans) == 2
    assert sum(s.name == "render.write" for s in job.spans) == 2
    assert sum(s.name == "deform.arap" for s in job.spans) == 2
    for stage in ("stage.refine", "stage.tsdf", "stage.render"):
        (st,) = [s for s in job.spans if s.name == stage]
        kids = sum(c.seconds for c in job.spans if c.parent == st.id)
        assert kids == pytest.approx(st.seconds - job.self_seconds(st),
                                     abs=1e-6)


def test_counters_read_the_sizes_of_the_inputs(body_jobs):
    rec, recorded, _, _ = body_jobs
    (job,) = rec.jobs()
    c = job.counters
    frames = 2 * FRAMES
    assert c["sweep.edges"] == FRAMES * FRAMES
    assert c["sweep.gap_rounds"] >= 1
    assert c["ba.cameras"] == frames
    assert c["ba.points"] > 0 and c["ba.observations"] >= 2 * c["ba.points"]
    assert c["ba.lm_iterations"] == 30
    assert 1 <= c["ba.lm_accepted"] <= 30
    assert c["tsdf.frames"] == frames
    model = recorded["Model.obj"].decode().splitlines()
    assert c["tsdf.vertices"] == c["trim.vertices_in"] >= sum(
        ln.startswith("v ") for ln in model)
    assert c["deform.scan_vertices"] == c["trim.vertices_kept"]
    assert c["deform.controls"] > 0
    assert c["deform.arap_iterations"] == 2 * 5
    assert "deform.cg_iterations" not in c     # 1,952 vertices: Cholesky
    assert c["render.frames"] == frames
    deform = recorded["deform.obj"].decode().splitlines()
    assert c["render.faces"] == 2 * sum(ln.startswith("f ")
                                        for ln in deform)
    rasters = sum(len(v) for k, v in recorded.items() if k.startswith("seq"))
    assert c["io.bytes.render"] == rasters
    assert c["io.bytes.deform.obj"] == len(recorded["deform.obj"])


def test_recording_off_records_nothing_and_changes_no_byte(body_jobs):
    rec, recorded, plain, ranges = body_jobs
    assert len(rec.jobs()) == 1
    assert ranges == []
    assert sorted(recorded) == sorted(plain)
    assert {k for k in recorded if k.startswith("seq")}
    for name in recorded:
        assert recorded[name] == plain[name], name
