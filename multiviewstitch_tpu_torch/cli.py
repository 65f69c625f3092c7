"""mvs CLI of the PyTorch port: ``align`` (the reference's -a 1
AlignmentSeq, Processor.cpp:835-1106), ``deform`` and ``render`` (its
second mode, Deform + Render, Processor.cpp:1108-1191) and ``pipeline``
(align -> deform -> render).

Usage:
  python -m multiviewstitch_tpu_torch.cli align --config <dir>/config.txt \
      [--backend poisson] [--write-mesh] [--set segment=true] \
      [--set all_seq_proj=true] [--refine [ba]] [--debug-artifacts] \
      [--device cuda]
  python -m multiviewstitch_tpu_torch.cli align --demo --device cpu --grid 48
  python -m multiviewstitch_tpu_torch.cli deform --workdir <wd> [--demo]
  python -m multiviewstitch_tpu_torch.cli render --workdir <wd> \
      [--config <dir>/config.txt]
  python -m multiviewstitch_tpu_torch.cli pipeline --demo --device cpu

``align`` writes Result/SRT.txt, Result/PSR.npts and Result/Model.obj (and,
with --write-mesh or WriteMesh, Models/model<k>_<i>.obj) under --workdir;
``deform`` fits the body template to Result/Model.obj (--demo: to a posed,
scaled copy of the template) and writes Result/deform.obj; ``render`` draws
deform.obj into every frame of every sequence of --config (each through
the inverse of its SRT.txt similarity) as <sequence>/DATA/Render/_depth<i>
.raw + .jpg, or without --config into a 4-camera ring framed on the model,
under <workdir>/DATA/Render. ``--refine`` refines the pose chain by a
pose graph, ``--refine ba`` by bundle adjustment; ``--debug-artifacts``
writes the chosen pairs' match dumps to <workdir>/Match; with
MVS_DEBUG_NUMERICS=1 in the environment ``align`` checks the pose chain
and the reconstructed mesh for non-finite values. The flags are those of
``multiviewstitch_tpu.cli`` plus --device (default cuda; there is no
fallback to the CPU) and --trace. The bench command is not ported: it
exits with a message and code 2.

``--trace DIR`` runs the command under torch.profiler with the program's
spans recorded (``utils/profiling.py``) and writes DIR/trace.json (the
Chrome trace: each span as an ``mvs.<name>`` range beside the card's
kernels) and DIR/spans.json (each span's seconds, self seconds and parent,
and the counters the command moved). The spans: ``job`` (the command; its
self time is the glue between stages), ``stage.<name>`` for each stage
(``prep``, ``sweep_solve``, ``fuse``, ``poisson``, ``trim_write``, ...),
``manifest.hash_inputs`` and ``manifest.mark_done``,
``trim.largest_component``, ``io.write_srt``, ``io.write_npts``,
``io.write_obj``, ``poisson.field`` / ``dilate`` / ``extract`` / ``slab``
/ ``weld``, ``kernels.build`` and ``io.native_build``; with ``--refine
ba`` ``ba.build`` / ``solve`` / ``refit``; with the TSDF ``tsdf.fuse`` /
``extract``; in ``deform`` ``deform.normals``, ``deform.remove_ground``,
``deform.init_alignment``, ``deform.part_recog``,
``deform.local_alignment``, ``deform.setup``, ``deform.correspondences``
and ``deform.arap``; in ``render`` ``render.raster`` and
``render.write``, one a sequence.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from .utils import profiling
from .utils.profiling import count, span

# commands of the JAX CLI this port does not implement yet (refused, never
# silently ignored)
_NOT_PORTED_CMDS = ("bench",)
# the camera view direction deform's rigid init fixes the scan's third
# principal axis against (the JAX CLI's)
VIEW_RAY = np.array([0.0, 0.0, 1.0])


def _log(msg: str):
    print(f"[mvs] {msg}", flush=True)


def demo_config():
    """The demo's StitchConfig: tests/test_e2e_align.py's CFG (config-2
    is this with max_keypoints=512)."""
    from .config import StitchConfig
    return StitchConfig().replace(
        view_count=1, min_match_count=7, iter_num=256, sample_interval=4,
        ssd_win=3, ssd_err=40.0, reproj_err=4, pixel_err=12.0,
        adapt_pixel_err_ratio=0.6, hl_margin_ratio=0.02,
        hr_margin_ratio=0.02, vl_margin_ratio=0.02, vr_margin_ratio=0.02,
        min_dsp=1e-3, max_dsp=10.0, max_keypoints=256, nbr_frm_num=1,
        conf_min=0.5, dsp_err=0.05)


def demo_transform(s: float = 1.25, t=(0.1, -0.05, 0.15)):
    """The demo's ground-truth similarity (14.3 degrees about +y)."""
    from .core.transforms import Similarity
    R = np.array([[0.9689124, 0.0, 0.24740396], [0.0, 1.0, 0.0],
                  [-0.24740396, 0.0, 0.9689124]], np.float32)
    return Similarity(torch.tensor(s, dtype=torch.float32),
                      torch.as_tensor(R), torch.tensor(t, dtype=torch.float32))


def build_demo_sequences(device, n_frames=5, width=128, height=96,
                         gt=None, arc_center_deg=0.0):
    """Two bumpy-sphere sequences related by ``gt`` (default
    demo_transform()), rendered on ``device``; the second sequence's
    45-degree camera arc is centred at ``arc_center_deg``. Returns (seqs,
    gt, base, moved)."""
    from .pipeline.align_seq import Sequence
    from .pipeline.fixtures import make_scene, textured_views
    gt = demo_transform() if gt is None else gt
    kw = dict(n_frames=n_frames, width=width, height=height, bumps=0.15,
              n_lat=64, n_lon=96, arc_deg=45.0, device=device)
    base = make_scene(**kw)
    moved = make_scene(transform=gt, arc_center_deg=arc_center_deg, **kw)
    seqs = [Sequence(textured_views(base), base.disparity, base.cams),
            Sequence(textured_views(moved), moved.disparity, moved.cams)]
    return seqs, gt, base, moved


def _apply_overrides(cfg, overrides):
    """--set key=value config overrides, coerced to the field's type."""
    if not overrides:
        return cfg
    names = {f.name for f in dataclasses.fields(cfg)}
    kw = {}
    for item in overrides:
        key, _, val = item.partition("=")
        if key not in names:
            raise SystemExit(f"unknown config key: {key}")
        t = getattr(cfg, key).__class__
        kw[key] = (val.lower() in ("1", "true", "yes") if t is bool
                   else t(val))
    return cfg.replace(**kw)


def _call(name, fn):
    return fn()


def _spanned(stage):
    """``stage`` with each step's work inside the span ``stage.<name>``
    (``_s`` dropped), opened inside the callable the hook runs, so a hook's
    own work around it stays outside the span."""
    def spanned(name, fn):
        def run():
            with span("stage." + name.removesuffix("_s")):
                return fn()
        return stage(name, run)
    return spanned


def write_frame_meshes(seqs, cfg, models_dir: str):
    """Per-frame Depth2Model dumps (Processor.cpp:873-914): one OBJ per
    frame from the raw disparity, gated by smooth_thres / edge_sz_thres,
    as Models/model<k>_<i>.obj."""
    from .io.meshio import write_obj
    from .ops.meshing import compact_mesh, grid_mesh
    os.makedirs(models_dir, exist_ok=True)
    for k, seq in enumerate(seqs):
        for i in range(seq.disparity.shape[0]):
            gm = grid_mesh(seq.disparity[i], seq.cams[i],
                           min_dsp=cfg.min_dsp, max_dsp=cfg.max_dsp,
                           smooth_thres=cfg.smooth_thres,
                           edge_sz_thres=cfg.edge_sz_thres)
            mv, mf, _ = compact_mesh(gm)
            write_obj(os.path.join(models_dir, f"model{k}_{i}.obj"), mv,
                      None, mf)


def run_align(seqs, cfg, grid: int, result_dir: str, stage=_call, *,
              backend: str = "tsdf", models_dir: str | None = None,
              refine=False, debug_dir: str | None = None,
              check_numerics: bool = False):
    """align [-> refine] -> fuse -> [per-frame meshes] -> TSDF or Poisson
    -> [AllSeqProj trim] -> largest component, then write SRT.txt,
    PSR.npts and Model.obj into ``result_dir``. Each step runs as
    ``stage(name, fn)`` — prep_s, sweep_solve_s, refine_s (with
    ``refine``: True / "pose_graph" or "ba"), fuse_s, write_mesh_s (with
    ``models_dir``), tsdf_s or poisson_s, all_seq_proj_s (with
    cfg.all_seq_proj) and trim_write_s — so a caller can time or profile
    them. ``debug_dir``: the match dumps' directory. ``check_numerics``:
    raise FloatingPointError at a non-finite pose chain or mesh (the fused
    cloud is always checked). The Poisson depth is min(cfg.psn_dpt_max,
    10). Returns (result, points, normals, verts, faces)."""
    from .io.meshio import write_obj, write_npts
    from .io.srt import save_srt
    from .pipeline.align_seq import align_sequences, fuse_sequences
    from .pipeline.match_edges import prep_sequence
    from .solvers.unionfind import retain_largest_component
    from .utils.debug_mode import check_finite, run_stage

    preps = stage("prep_s", lambda: [prep_sequence(s, cfg) for s in seqs])
    result = run_stage(lambda: align_sequences(
        seqs, cfg, seed=0, preps=preps, refine=refine, debug_dir=debug_dir,
        stage=stage), stage="align")
    _log(f"pose chain solved (residuals {result.residuals})"
         + (f"; refined: {result.metrics}" if refine else ""))
    if check_numerics:
        for k, T in enumerate(result.transforms):
            check_finite("align", **{f"s{k}": T.s, f"R{k}": T.R,
                                     f"t{k}": T.t})
    pts, nrm = stage("fuse_s", lambda: run_stage(
        fuse_sequences, seqs, result, cfg, stage="fuse"))
    check_finite("fuse", points=pts, normals=nrm)
    _log(f"fused cloud: {len(pts)} oriented points")
    if models_dir is not None:
        stage("write_mesh_s", lambda: write_frame_meshes(seqs, cfg,
                                                         models_dir))
        _log(f"WriteMesh: per-frame Depth2Model OBJs -> {models_dir}")

    if backend == "poisson":
        # the reference's reconstructor: screened Poisson over the fused
        # oriented cloud (RunPoisson on PSR.npts, Processor.cpp:1042)
        from .ops.poisson import reconstruct_poisson
        depth = min(cfg.psn_dpt_max, 10)
        if cfg.psn_dpt_max > 10:
            _log(f"Poisson depth capped at 10 (PsnDptMax {cfg.psn_dpt_max})")
        dev = seqs[0].disparity.device
        verts, faces = stage("poisson_s", lambda: reconstruct_poisson(
            pts, nrm, depth=depth, device=dev))
    else:
        from .ops.tsdf import fuse_multi_sequence
        verts, faces, _ = stage("tsdf_s", lambda: fuse_multi_sequence(
            [s.disparity for s in seqs], [s.cams for s in seqs],
            result.transforms, grid=grid, min_dsp=cfg.min_dsp,
            max_dsp=cfg.max_dsp))
    if check_numerics:
        check_finite("reconstruct", vertices=verts)

    if cfg.all_seq_proj:
        # AllSeqProj trim (Processor.cpp:1064-1102): keep only vertices
        # that project into every sequence's cameras
        from .ops.segmentation import trim_mesh_by_all_cameras
        n_before = len(verts)
        verts, faces, _ = stage("all_seq_proj_s",
                                lambda: trim_mesh_by_all_cameras(
                                    verts, faces, None, result.transforms,
                                    [s.cams for s in seqs]))
        _log(f"AllSeqProj trim: {n_before} -> {len(verts)} verts")

    def trim_write():
        with span("trim.largest_component"):
            v, f, _ = retain_largest_component(verts, faces)
        count("trim.vertices_in", len(verts))
        count("trim.vertices_kept", len(v))
        save_srt(os.path.join(result_dir, "SRT.txt"), result.transforms)
        write_npts(os.path.join(result_dir, "PSR.npts"), pts, nrm)
        write_obj(os.path.join(result_dir, "Model.obj"), v, None, f)
        return v, f
    verts, faces = stage("trim_write_s", trim_write)
    _log(f"SRT.txt, PSR.npts and Model.obj ({len(verts)} verts / "
         f"{len(faces)} faces) written")
    return result, pts, nrm, verts, faces


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")
    return device


def cmd_align(args, stage=_call) -> int:
    """The align command; ``stage`` as in ``run_align`` (it also times
    ``ingest_s`` for --config)."""
    from .config import load_legacy_config
    from .io.manifest import StageManifest, hash_arrays

    device = _device(args)
    if not args.demo and not args.config:
        _log("need --demo or --config (see docs/DATA.md for the layout)")
        return 2
    cfg = (load_legacy_config(args.config) if args.config
           else demo_config())
    cfg = _apply_overrides(cfg, args.set)

    t0 = time.perf_counter()
    if args.config:
        from .pipeline.ingest import load_sequences
        base_dir = os.path.dirname(os.path.abspath(args.config))
        seqs = stage("ingest_s", lambda: load_sequences(cfg, base_dir,
                                                        device=device))
        _log(f"loaded {len(seqs)} sequences from {base_dir}")
    else:
        seqs, _, _, _ = build_demo_sequences(device)
    manifest = StageManifest(args.workdir)
    result_dir = manifest.stage_dir("Result")
    # checkpoint/resume: skip when the disparities, config and options are
    # unchanged (the JAX CLI's hash, plus the device)
    write_mesh = args.write_mesh or cfg.write_mesh
    opts = (f"{args.grid}:{args.backend}:{args.write_mesh}:{args.refine}:"
            f"{args.device}")
    with span("manifest.hash_inputs"):
        in_hash = hash_arrays(
            cfg=np.frombuffer(repr(cfg).encode(), dtype=np.uint8),
            opts=np.frombuffer(opts.encode(), dtype=np.uint8),
            **{f"d{i}": s.disparity.cpu().numpy()
               for i, s in enumerate(seqs)})
    if manifest.is_done("align", in_hash) and not args.force:
        _log("align stage up to date (manifest hash match) — skipping; "
             "pass --force to recompute")
        return 0

    _log(f"aligning {len(seqs)} sequences on {device} ...")
    grid = args.grid or min(1 << cfg.psn_dpt_max, 256)
    if (args.backend == "tsdf" and not args.grid and
            (1 << cfg.psn_dpt_max) > 256):
        _log(f"TSDF grid capped at 256 (PsnDptMax {cfg.psn_dpt_max} -> "
             f"{1 << cfg.psn_dpt_max}); use --backend poisson for full "
             "depth or --grid to override")
    models_dir = manifest.stage_dir("Models") if write_mesh else None
    debug_dir = (os.path.join(args.workdir, "Match")
                 if args.debug_artifacts else None)
    _, pts, _, verts, faces = run_align(
        seqs, cfg, grid, result_dir, stage, backend=args.backend,
        models_dir=models_dir, refine=args.refine or False,
        debug_dir=debug_dir,
        check_numerics=os.environ.get("MVS_DEBUG_NUMERICS") == "1")
    with span("manifest.mark_done"):
        manifest.mark_done("align", [os.path.join(result_dir, f)
                                     for f in ("SRT.txt", "PSR.npts",
                                               "Model.obj")],
                           input_hash=in_hash,
                           metrics={"points": len(pts), "verts": len(verts),
                                    "faces": len(faces)})
    _log(f"align done in {time.perf_counter() - t0:.1f}s")
    return 0


def demo_scan():
    """deform --demo's scan (the JAX CLI's): the template with its arms
    posed 18 degrees down, scaled by 1.1 and moved. Returns (vertices,
    faces) as numpy."""
    from .models.template_body import make_template, pose_template
    tv, tf, tl = make_template()
    posed = pose_template(tv, tl, arm_angle_deg=18.0)
    return (1.1 * posed + np.array([0.15, 0.0, -0.05])).astype(np.float32), tf


def run_deform(template, scan, out_obj: str, passes: int, stage=_call):
    """Fit ``template`` to ``scan`` (pipeline.deform_render.Mesh on one
    device) in ``passes`` ARAP passes and write ``out_obj``, as
    ``stage("deform_s", fn)``; inside it the rigid alignment and each pass
    run as ``stage("deform_align_s", fn)`` and ``stage("deform_pass<k>_s",
    fn)``. Returns the DeformStageResult."""
    from .pipeline.deform_render import deform_stage
    return stage("deform_s", lambda: deform_stage(
        template, scan, VIEW_RAY, deform_passes=passes, out_obj=out_obj,
        stage=stage))


def run_render(verts, faces, transforms, cams_list, out_dirs, stage=_call):
    """Render the model (tensors) into every camera batch of ``cams_list``
    through the inverse of each similarity and write the rasters under
    ``out_dirs``, as ``stage("render_s", fn)``. Returns (per-sequence
    disparities, coverage metrics)."""
    from .pipeline.deform_render import render_stage
    metrics = {}
    outs = stage("render_s", lambda: render_stage(
        verts, faces, transforms, cams_list, out_dirs=out_dirs,
        metrics=metrics))
    return outs, metrics


def cmd_deform(args, stage=_call) -> int:
    """Template fitting (the reference's Deform, Processor.cpp:1108-1138);
    ``stage`` as in ``run_deform``."""
    from .interop import mesh_from_numpy
    from .io.native_loader import parse_obj
    from .models.template_body import make_template

    device = _device(args)
    result_dir = os.path.join(args.workdir, "Result")
    os.makedirs(result_dir, exist_ok=True)
    tv, tf, tl = make_template()
    if args.demo:
        scan_v, scan_f = demo_scan()
    else:
        model = os.path.join(result_dir, "Model.obj")
        if not os.path.exists(model):
            _log(f"{model} not found — run `align` (or `pipeline`) first")
            return 2
        scan_v, _, scan_f = parse_obj(model)
    res = run_deform(mesh_from_numpy(tv, tf, tl, device=device),
                     mesh_from_numpy(scan_v, scan_f, device=device),
                     os.path.join(result_dir, "deform.obj"), args.passes,
                     stage)
    _log(f"deform.obj written ({len(res.vertices)} verts, fitted to "
         f"{len(scan_v)} scan verts on {device})")
    return 0


def cmd_render(args, stage=_call) -> int:
    """Model -> per-frame depth re-render (the reference's Render +
    Model2Depth, Processor.cpp:1140-1191); ``stage`` as in
    ``run_render``."""
    from .core.transforms import Similarity
    from .io.native_loader import parse_obj
    from .io.srt import load_srt

    device = _device(args)
    result_dir = os.path.join(args.workdir, "Result")
    deform_path = os.path.join(result_dir, "deform.obj")
    if not os.path.exists(deform_path):
        _log(f"{deform_path} not found — run `deform` (or `pipeline`) "
             "first")
        return 2
    verts, _, faces = parse_obj(deform_path)
    srt_path = os.path.join(result_dir, "SRT.txt")
    transforms = (load_srt(srt_path) if os.path.exists(srt_path)
                  else [Similarity.identity(device="cpu")])
    v_t = torch.as_tensor(verts, device=device)
    f_t = torch.as_tensor(faces.astype(np.int64), device=device)
    if args.config:
        # real cameras: each sequence dir's .act (LoadCameras,
        # Processor.cpp:1167-1169), rendered into its own DATA/Render
        import glob
        from .config import load_legacy_config
        from .core.cameras import load_act
        cfg = load_legacy_config(args.config)
        base_dir = os.path.dirname(os.path.abspath(args.config))
        cams_list, out_dirs = [], []
        for d in cfg.image_dirs:
            full = d if os.path.isabs(d) else os.path.join(base_dir, d)
            acts = sorted(glob.glob(os.path.join(full, "*.act")))
            if not acts:
                _log(f"no .act calibration in {full}")
                return 2
            cams_list.append(load_act(acts[0], device=device))
            out_dirs.append(full)
        transforms = transforms + [Similarity.identity(device="cpu")] * (
            len(cams_list) - len(transforms))
        outs, rmetrics = run_render(v_t, f_t, transforms[:len(cams_list)],
                                    cams_list, out_dirs, stage)
    else:
        # demo cameras: a ring framed on the model's bounding sphere, in the
        # model's own frame, so the render transform is the identity (the
        # align chain's SRT would move the model out of the framed view)
        from .pipeline.fixtures import ring_cameras
        center = verts.mean(0)
        bound = float(np.linalg.norm(verts - center, axis=1).max())
        # 1.8x the bounding radius frames a tall humanoid at ~10 % pixel
        # coverage while keeping the limbs inside the frustum over the arc
        cams = ring_cameras(4, radius=max(1.8 * bound, 1e-3), width=160,
                            img_height=120, arc_deg=60.0,
                            look_at=tuple(center.tolist()), device=device)
        outs, rmetrics = run_render(v_t, f_t,
                                    [Similarity.identity(device="cpu")],
                                    [cams], [args.workdir], stage)
    cover = rmetrics["render_coverage"]
    n_frames = sum(o.shape[0] for o in outs)
    _log(f"rendered {n_frames} frames over {len(outs)} sequence(s) on "
         f"{device}, coverage {cover:.1%}")
    if cover < 0.005:
        _log("WARNING: rendered depth covers <0.5% of the frame — the "
             "model is likely not where the cameras look (check SRT.txt "
             "/ camera calibration)")
    return 0


def cmd_pipeline(args, stage=_call) -> int:
    """align -> deform -> render; ``stage`` as in each."""
    for cmd in (cmd_align, cmd_deform, cmd_render):
        rc = cmd(args, stage)
        if rc:
            return rc
    return 0


def _not_ported(args) -> int:
    _log(f"`{args.cmd}` is not ported to multiviewstitch_tpu_torch yet; use "
         "python -m multiviewstitch_tpu.cli for it")
    return 2


def _run(args, stage) -> int:
    """The command inside its ``job`` span, each stage in its span."""
    with span(profiling.JOB, cmd=args.cmd):
        return args.fn(args, _spanned(stage))


def _run_traced(args, stage) -> int:
    """``_run`` under torch.profiler with spans recorded; writes
    trace.json and spans.json into ``args.trace``."""
    with profiling.recording() as rec:
        n_before = len(rec.jobs())
        with profiling.trace(args.trace):
            rc = _run(args, stage)
        profiling.write_spans(os.path.join(args.trace, profiling.SPANS_FILE),
                              rec.jobs()[n_before:])
    _log(f"trace and spans written to {args.trace}")
    return rc


def main(argv=None, stage=_call) -> int:
    """Parse ``argv`` and run the command; ``stage`` as in ``run_align``,
    ``run_deform`` and ``run_render``."""
    ap = argparse.ArgumentParser(prog="mvs-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--workdir", default="./mvs_work")
    common.add_argument("--config", default=None,
                        help="legacy reference config.txt")
    common.add_argument("--demo", action="store_true",
                        help="run on synthetic fixtures")
    common.add_argument("--set", action="append", metavar="KEY=VALUE",
                        help="override any StitchConfig field")
    common.add_argument("--device", default="cuda",
                        help="torch device (default cuda; no CPU fallback)")
    common.add_argument("--trace", default=None, metavar="DIR",
                        help="profile the command and record its spans: "
                             "writes DIR/trace.json (Chrome trace, spans "
                             "as mvs.<name> ranges) and DIR/spans.json "
                             "(span seconds and counters)")

    align = argparse.ArgumentParser(add_help=False)
    align.add_argument("--grid", type=int, default=None,
                       help="TSDF grid resolution (default 2^PsnDptMax "
                            "capped at 256)")
    align.add_argument("--backend", choices=("tsdf", "poisson"),
                       default="tsdf",
                       help="surface reconstruction backend (the "
                            "reference's is Poisson, at depth "
                            "min(PsnDptMax, 10); tsdf is the denser "
                            "multi-sequence fusion)")
    align.add_argument("--write-mesh", action="store_true",
                       help="per-frame Depth2Model OBJ dumps (WriteMesh)")
    align.add_argument("--force", action="store_true",
                       help="recompute even if the manifest says up to "
                            "date")
    align.add_argument("--refine", nargs="?", const="pose_graph",
                       default=None, choices=("pose_graph", "ba"),
                       help="view-graph refinement: bare --refine = global "
                            "similarity pose graph over all matches; "
                            "--refine ba = reprojection bundle adjustment "
                            "over keyframe cameras + merged pixel tracks")
    align.add_argument("--debug-artifacts", action="store_true",
                       help="dump match visualizations to <workdir>/Match/")
    passes = argparse.ArgumentParser(add_help=False)
    passes.add_argument("--passes", type=int, default=2,
                        help="ARAP deform passes")

    sub.add_parser("align", parents=[common, align]).set_defaults(
        fn=cmd_align)
    sub.add_parser("deform", parents=[common, passes]).set_defaults(
        fn=cmd_deform)
    sub.add_parser("render", parents=[common]).set_defaults(fn=cmd_render)
    sub.add_parser("pipeline", parents=[common, align, passes]).set_defaults(
        fn=cmd_pipeline)
    for name in _NOT_PORTED_CMDS:
        p = sub.add_parser(name, parents=[common], add_help=False)
        p.set_defaults(fn=_not_ported)

    args, extra = ap.parse_known_args(argv)
    if args.fn is _not_ported:
        return _not_ported(args)
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.trace:
        return _run_traced(args, stage)
    return _run(args, stage)


if __name__ == "__main__":
    sys.exit(main())
