"""Readings the limits of the correctness check are set from (PERF.md
gives them beside each limit). Not run by the benchmark's runs.

    python3 mvsbench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--fault-seeds 3] [--out readings.json]

For each seed, one job of the cell at its own size (the load of a run:
one job in flight) is judged three ways:
  - ``sound``: the job's outputs against the reference (the lower
    readings);
  - ``control``: the reference computed with TF32 operands put in the
    job's place: its fused cloud (for PSR.npts) and its re-render (for the
    rasters), judged against the float32 reference; the other outputs are
    the job's (the upper readings of the numbers the control moves);
  - on the first ``--fault-seeds`` seeds, the job again with one fault
    planted in the port (``faults_for``), each judged the same way; a job
    the fault makes fail reads ``job_failed``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


@contextlib.contextmanager
def _patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def fault_state_unchanged():
    """The alignment returns the pose chain it started from (identity)."""
    from multiviewstitch_tpu_torch.core.transforms import Similarity
    from multiviewstitch_tpu_torch.pipeline import align_seq

    def make(old):
        def align_sequences(seqs, *a, **kw):
            res = old(seqs, *a, **kw)
            res.transforms = [Similarity.identity(device="cpu")
                              for _ in seqs]
            return res
        return align_sequences
    return _patched(align_seq, "align_sequences", make)


def fault_fit_unchanged():
    """The template fit returns the template as it came in."""
    import torch
    from multiviewstitch_tpu_torch.io.meshio import write_obj
    from multiviewstitch_tpu_torch.pipeline import deform_render

    def make(old):
        def deform_stage(template, scan, view_ray, *a, out_obj=None, **kw):
            v, f = template.vertices, template.faces
            if out_obj:
                write_obj(out_obj, v.cpu().numpy(), None, f.cpu().numpy())
            return deform_render.DeformStageResult(v, f, torch.zeros_like(v))
        return deform_stage
    return _patched(deform_render, "deform_stage", make)


def fault_half_batch():
    """The fuse takes the first half of each sequence's frames."""
    from multiviewstitch_tpu_torch.pipeline import align_seq

    def make(old):
        def fuse_sequences(seqs, result, cfg):
            half = [align_seq.Sequence(s.gray[:len(s.gray) // 2],
                                       s.disparity[:len(s.gray) // 2],
                                       s.cams[:len(s.gray) // 2])
                    for s in seqs]
            return old(half, result, cfg)
        return fuse_sequences
    return _patched(align_seq, "fuse_sequences", make)


def fault_poisson_unchanged():
    """The Poisson solve returns the field it started from (zero)."""
    from multiviewstitch_tpu_torch.ops import poisson

    def vcycle(old):
        def _vcycle(x, b, screen, **kw):
            return x
        return _vcycle

    def cg(old):
        def _cg(b, screen, iters):
            return torch.zeros_like(b)
        return _cg
    import torch
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(poisson, "_vcycle", vcycle))
    stack.enter_context(_patched(poisson, "_cg", cg))
    return stack


def fault_points_altered():
    """The fused cloud's points move by 1e-4 where they are produced."""
    from multiviewstitch_tpu_torch.pipeline import align_seq

    def make(old):
        def fuse_sequences(*a, **kw):
            pts, nrm = old(*a, **kw)
            return pts + 1e-4, nrm
        return fuse_sequences
    return _patched(align_seq, "fuse_sequences", make)


def fault_raster_altered():
    """The re-rendered disparities are 0.1 % too large where drawn."""
    from multiviewstitch_tpu_torch.pipeline import deform_render

    def make(old):
        def render_sequence(*a, **kw):
            return old(*a, **kw) * 1.001
        return render_sequence
    return _patched(deform_render, "render_sequence", make)


FAULTS = {"state_unchanged": fault_state_unchanged,
          "half_batch": fault_half_batch,
          "points_altered": fault_points_altered}
RENDER_FAULTS = {"fit_unchanged": fault_fit_unchanged,
                 "raster_altered": fault_raster_altered}


def faults_for(cell):
    out = dict(FAULTS)
    if "poisson" in cell.config["command"]:
        out["poisson_unchanged"] = fault_poisson_unchanged
    if cell.config.get("render"):
        out.update(RENDER_FAULTS)
    return out


def control_numbers(runner, judge, sound: dict, workdir: str) -> dict:
    """The numbers with the TF32 reference in the job's place."""
    from mvsbench import reference as ref
    from mvsbench.judge import Judge, cloud_numbers, render_numbers
    low = Judge(runner.scene, runner.cell.config, judge.device, "tf32")
    res = os.path.join(workdir, "Result")
    srt = ref.read_srt(os.path.join(res, "SRT.txt"))
    out = dict(sound)
    out.update(cloud_numbers(*low.reference_cloud(srt),
                             *judge.reference_cloud(srt)))
    if runner.cell.config.get("render"):
        fv, ff = ref.read_obj(os.path.join(res, "deform.obj"))
        cams = [f.cams.to(judge.device) for f in runner.scene.sequences]
        mine = [r.cpu().numpy() for r in ref.render(fv, ff, srt, cams,
                                                    low.mat)]
        theirs = [r.cpu().numpy() for r in ref.render(fv, ff, srt, cams,
                                                      judge.mat)]
        out.update(render_numbers(mine, theirs))
    return out


def readings(cell, seed: int, device, faults=()) -> dict:
    """Sound, control and fault numbers of one seed."""
    from mvsbench import spec
    from mvsbench.harness import Runner
    from mvsbench.judge import Judge
    scene = spec.scene(cell.traffic["scene"]).generate(cell.traffic, seed,
                                                       device)
    root = tempfile.mkdtemp(prefix="mvsbench-calib-")
    try:
        runner = Runner(cell, scene, root, device)
        judge = Judge(scene, cell.config, device)
        job = runner.job()
        if not job.ok:
            return {"sound": {"job_failed": math.inf}}
        out = {"job_s": job.end - job.start,
               "sound": judge.job(job.workdir, runner.render_dirs())}
        out["control"] = control_numbers(runner, judge, out["sound"],
                                         job.workdir)
        all_faults = faults_for(cell)
        for name in faults:
            with all_faults[name]():
                job = runner.job()
            out[name] = (judge.job(job.workdir, runner.render_dirs())
                         if job.ok else {"job_failed": math.inf})
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    import torch
    from mvsbench import spec
    ap = argparse.ArgumentParser(prog="mvsbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--faults", default=None,
                    help="comma-separated names (default: every fault)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("mvsbench.calibrate: no CUDA device")
    cell = spec.cell(args.workload, spec.benchmark())
    seeds = [int(s) for s in args.seeds.split(",")]
    names = (args.faults.split(",") if args.faults
             else list(faults_for(cell)))
    result = {"workload": args.workload,
              "device": torch.cuda.get_device_name(0), "seeds": {}}
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        r = readings(cell, seed, torch.device("cuda"),
                     names if i < args.fault_seeds else ())
        result["seeds"][str(seed)] = r
        print(json.dumps({"seed": seed, "s": time.perf_counter() - t0,
                          **r}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
