"""On-card smoke run of the PyTorch port (multiviewstitch_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU, nvcc and this repository's sources; imports no jax.
Phases, in order (any failure raises and the exit code is non-zero):
  1. device: the card's name and power limit (nvidia-smi)
  2. build: one nvcc per csrc/*.cu source, all started together, into
     the git-ignored kernel directory; g++ builds the native IO library
     (csrc/mvs_io.cpp) that the ingest reads raw depth through
  3. kernels: K1 (consistency), K2 (the oriented point sampler) and K3
     (raster), each against its plain PyTorch version on the card. K1 and
     K2 at three sizes of the sphere scene (640x480): config-2 (5 frames,
     nbr_num 1), the front-end (8 frames, bench.py's settings, nbr_num 2)
     and a long sequence (64 frames on the 45-degree arc, the reference's
     default settings, nbr_num 5; 78.6 MB of disparity, more than L2); K1
     bit-identical (at 64 frames also at offsets -2, -1, 1, 2), K2's
     points bit-identical, conf and the keep mask
     equal on >= 99.99 % of samples, normals within 1e-6 on >= 99.99 % of
     the samples both keep. K3 bit-identical on six cases (the config-2
     sphere, a ~100k-face sphere, two close-up giant faces, a close-up
     ring of 8 cameras around and inside a 100k-face sphere, and phase
     8's two shapes: the body drawn through inverse(gt) into 12 portrait
     frames, and render_bench's config-3 ring), with each
     case's largest clipped bbox and (face, tile) pair count (the kernel's
     own total). Each case logs kernel and plain ms (median of 20 timed
     runs, CUDA events), device us per CUDA kernel (torch.profiler) and
     the least time the card could take (bound) with its share. Then K4
     (the Poisson field's stencils) at the scan's 1024^3: one Jacobi
     sweep, one box-blur pass along each axis and one V-cycle from x = 0,
     each bit-identical to the plain code of ops/poisson on the card and
     timed the same way (the V-cycle's bound: every launch's inputs read
     once and outputs written once)
  4. the align slice at config-2 (2 sequences x 5 frames at 640x480,
     max_keypoints 512, TSDF grid 256) through ``cli.run_align``: render,
     prep, edge sweep + solve, fuse, TSDF, trim + write; checks the
     recovered similarity, the fused cloud's RMSE and that every kernel
     launched during the run; then once more with the second sequence's
     camera arc centred half a frame step away, so that no keyframe pair
     shares a pose and RANSAC has to reject outliers; then five more runs,
     each with the launch counts zeroed before it and K1-K3 required after
     it: config-2 under ``fixtures.sensor_noise`` at 1x and at 2x (seed k
     for sequence k) held to the JAX noise test's limits (s 8 %, 5 deg,
     0.15), the turned arc refined by the pose graph and by bundle
     adjustment (``run_align(..., refine=...)``, hard limits, BA RMSE not
     above its start) and the noisy 1x run refined by BA; logs refine_s,
     the refinement metrics and the TSDF mesh's vertex count beside the
     JAX package's 65,536 cap
  5. the CLI: ``align --demo --device cuda``, ``align --demo --refine ba
     --debug-artifacts --device cuda`` (checks the Match/*.png dump and
     that K1 and K2 launched), then ``pipeline --demo --device cuda``
     (align, deform, render; checks SRT.txt, PSR.npts, Model.obj,
     deform.obj and the four DATA/Render rasters)
  6. profile: each stage of the warm slice under torch.profiler; device
     busy time is the union of the device-side events' intervals
  7. config: the config-2 scene (rendered by K3) written in the
     reference's on-disk layout (cameras.act, DATA/_depth<i>.raw, JPEG
     frames, imgPathList.txt, a legacy config.txt with config-2's knobs),
     then ``cli.main(["align", "--config", ..., "--backend", "poisson",
     "--write-mesh", "--set", "segment=true", "--set", "all_seq_proj=true",
     "--set", "max_keypoints=512", "--device", "cuda", "--force"])`` at
     the default PsnDptMax 10 (Poisson at 1024^3); checks SRT.txt against
     the ground truth, PSR.npts, Model.obj's vertex RMSE to the true
     surface, the ten per-frame meshes, that K1 and K2 launched and that
     K4 launched SCAN_STENCIL_LAUNCHES (468) times; logs
     per-stage synced wall times, the Poisson stage's peak device memory,
     the grid and the mesh sizes; the ingest must read the raw depth
     through the native library; the depth-10 run's Poisson stage runs
     under torch.profiler with the port's spans recorded (device busy
     share, and each step's host span and device time from the
     ``mvs.poisson.*`` ranges);
     then a warm pass at psn_dpt_max 8 (256^3, whole-grid extraction);
     Model.obj's vertex count must equal the exact largest component
     (scipy's connected_components, counted here) of the depth-10 mesh,
     and the host time of the largest-component pass is logged
  8. body, the reference's second mode at bench/body_bench.py's scale:
     the posed template (arms 15, legs 5 degrees) rendered by K3 into two
     12-frame 480x640 portrait sequences on a full ring of radius 2.8
     (the second moved by s 1.12, 9 degrees of yaw, t (0.12, -0.06, 0.1)),
     with textured views, written in the reference's layout with
     config-2's knobs (body_bench's config); ``cli.main(["align",
     "--config", ..., "--refine", "ba", "--grid", "160", "--set",
     "max_keypoints=512", "--device", "cuda", "--force"])`` aligns the two
     sequences by bundle adjustment (held to the hard limits against the
     true similarity, K1 and K2 launched) and writes the TSDF scan as
     Result/Model.obj; the scan fused through the true similarity is
     logged as a control; then ``cli.main(["deform", ...])`` fits that
     run's Model.obj on the card (cold, warm, and warm with
     deform_s under torch.profiler) and on the CPU, and ``cli.main(
     ["render", "--config", ...])``; checks deform.obj's fit RMS to the
     scan (< 0.06) and vertex count, the card's deform against the CPU's
     (within 1e-3, the card test's bound), 24 rasters written with K3
     launched, and a control render of the scan mesh (measured overlap >
     0.9); logs
     the synced stage and pass times, the scan's vertex count, deform_s's
     device-busy share, the template's coverage and overlap; then the
     config-3 loop at bench/render_bench.py's shape (8 VGA frames of a
     99,904-face sphere on the 90-degree ring, ``render_stage(...,
     refine=True)``) in ms per outer iteration, held to the plain render
     of the same inputs refined on the CPU
  9. bundle adjustment at a realistic size: 64 cameras x 16,384 points,
     every camera seeing every point (1,048,576 observations), built as
     bench/solvers.py's synth_ba builds it (0.5 px noise, a perturbed
     start; cameras 0 and 63 fixed); 20 LM iterations of ``solve_ba`` on
     the card (final RMSE < 1.0 px), held against the CPU after 5
     iterations (state within 1e-3); logs ms per LM iteration (CUDA
     events, median), the peak device memory and the device-busy share
 10. parallel, the multi-device layer at NCCL world size 1 (one card: the
     tests hold 2 to 4 gloo ranks): make_mesh() (NCCL, a file:// store),
     its all_reduce and all_gather (every helper runs its collective at
     world size 1 too, so each case below runs on NCCL); the windowed filter on the 64-frame VGA sequence at halo 1 and 2,
     bit-identical to check_consistency at +-1..+-halo, K1 launched once
     through it; config-5 at full width (2 x 32 VGA frames on a 120-degree
     arc, the second moved by s 1.15, 10 degrees, t (0.1, -0.05, 0.15);
     config-2's knobs with iter_num 64: 1,024 edges) through
     align_sequences(mesh=), identical to the unsharded run, within s 8 %
     and 4 degrees, then the fuse, K1-K3 launched from zeroed counts (stage
     times, peak memory, the sweep's busy share under utils.profiling.trace,
     device_time, compiled_flops of a 512^2 matmul); refine="ba" through the
     mesh on phase 4's turned arc (within 1e-3 of the unsharded
     refinement); solve_ba_sharded at phase 9's shape (ms per LM iteration
     beside phase 9's, state within 1e-3 of solve_ba after 5); both ARAP
     layouts on phase 8's body ARAP problem (within 5e-3 of arap_solve)
The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(REPO, "multiviewstitch_tpu_torch")):
    raise SystemExit("chip_smoke.py: run it from a checkout of the repository "
                     "(multiviewstitch_tpu_torch/ not found beside it)")
sys.path.insert(0, REPO)

from multiviewstitch_tpu_torch import kernels  # noqa: E402
from multiviewstitch_tpu_torch.cli import (  # noqa: E402
    build_demo_sequences, demo_config, demo_transform, run_align)
from multiviewstitch_tpu_torch.config import StitchConfig  # noqa: E402
from multiviewstitch_tpu_torch.kernels import _build  # noqa: E402
from multiviewstitch_tpu_torch.ops import rasterizer as tr  # noqa: E402
from multiviewstitch_tpu_torch.utils import profiling  # noqa: E402

CFG = demo_config().replace(max_keypoints=512)    # config-2
W, H, N_FRAMES, GRID = 640, 480, 5, 256
GT_S, GT_T = 1.3, (0.15, -0.1, 0.2)
ARC_CENTER_DEG = 45.0 / (N_FRAMES - 1) / 2        # half a frame step
# the close-up ring's 90-degree arc is centred on the sphere (z = 2.5 at
# ring radius 2.5): its middle cameras sit inside the sphere, whose wall
# then crosses their image plane at grazing angles (giant faces)
CLOSE_UP_ARC_CENTER_DEG = 90.0
SOURCES = {
    "consistency": ("multiviewstitch_tpu_torch/csrc/consistency.cu",
                    "multiviewstitch_tpu/ops/pallas_gather.py:111"),
    "oriented_points": ("multiviewstitch_tpu_torch/csrc/sampling.cu",
                        "multiviewstitch_tpu/ops/pallas_gather.py:111"),
    "raster": ("multiviewstitch_tpu_torch/csrc/raster.cu",
               "multiviewstitch_tpu/ops/pallas_raster.py:302"),
    "stencil": ("multiviewstitch_tpu_torch/csrc/stencil.cu", None),
}
# the kernels of the TSDF slices and config-5 (K4 serves Poisson only)
SLICE_KERNELS = ("consistency", "oriented_points", "raster")
# K4 launches of one Poisson field at depth 10: 12 V-cycles x (levels
# 1024..32: 2 sweeps, the restricted residual, the prolongation, 2 sweeps;
# 16^3: one launch), and the box blur's 6 axis passes on 4 grids
SCAN_STENCIL_LAUNCHES = 12 * (6 * 6 + 1) + 4 * 6
STENCIL_SIDE = 1024
# the H100 SXM's published peaks (at its full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# K1 / K2 sizes: (name, frames, K2 settings). Each renders the config-2
# sphere scene (45-degree arc, 640x480) and keeps config-2's disparity
# range and reproj_err 4: the sphere's near side lies at disparity
# 0.5-0.7, so the reference's default max_dsp 0.5 would drop it.
_DEFAULTS = StitchConfig()
K12_SIZES = (
    ("config-2", N_FRAMES, dict(
        sample_radius=CFG.sample_radius, nbr_num=CFG.nbr_frm_num,
        nbr_step=CFG.nbr_frm_step, dsp_err=CFG.dsp_err,
        conf_min=CFG.conf_min)),
    ("front-end", 8, dict(             # bench.py's front-end step
        sample_radius=2, nbr_num=2, nbr_step=1, dsp_err=0.05, conf_min=0.5)),
    ("long sequence", 64, dict(        # the reference's defaults
        sample_radius=_DEFAULTS.sample_radius,
        nbr_num=_DEFAULTS.nbr_frm_num, nbr_step=_DEFAULTS.nbr_frm_step,
        dsp_err=_DEFAULTS.dsp_err, conf_min=_DEFAULTS.conf_min)),
)
K1_KW = dict(min_dsp=CFG.min_dsp, max_dsp=CFG.max_dsp,
             reproj_err=CFG.reproj_err)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=20):
    """Median of ``reps`` runs of fn, each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    log(f"device: {name} (count {torch.cuda.device_count()}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return name, smi_line


def phase_build():
    from multiviewstitch_tpu_torch.io import native_loader
    t0 = time.perf_counter()
    path = _build.LIB.build(verbose=True)
    _build.load()
    log(f"build: {path} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {'ran' if profiling.counters('kernels.built') else 'cached'})")
    t0 = time.perf_counter()          # the ingest's reader, built here so
    ok = native_loader.native_available()       # ingest_s is all reading
    log(f"build: native IO {native_loader.LIB.path()} in "
        f"{time.perf_counter() - t0:.2f} s")
    assert ok, "the native IO library did not build"


def config2_sequences(dev, arc_center_deg=0.0):
    return build_demo_sequences(dev, n_frames=N_FRAMES, width=W, height=H,
                                gt=demo_transform(s=GT_S, t=GT_T),
                                arc_center_deg=arc_center_deg)


def kernel_breakdown(fn, reps=5):
    """Device microseconds per call of each kernel ``fn`` launches, and of
    all of them together, from torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            short = name.replace("void ", "").split("(")[0][-40:]
            by_name[short] = by_name.get(short, 0.0) + \
                e.time_range.elapsed_us() / reps
    return by_name


def bound(n_bytes, flops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``n_bytes`` and do ``flops`` float32 operations, and which one sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def existing_neighbours(n, offsets):
    """[n] count of frames f + o (o in offsets) inside 0..n-1."""
    f = torch.arange(n)
    return sum(((f + o >= 0) & (f + o < n)).long() for o in offsets)


def k1_bound(d, offsets=(-1, 1)):
    """K1 reads and writes each disparity once (plus the cameras); per valid
    pixel 25 flops (1/d, unprojection) and per existing neighbour 88 (two
    projections of 25, an unprojection of 24 and 1/d, two roundings of 4,
    the error test of 5): csrc/consistency.cu. The neighbours' gathers hit
    L2 and count no bytes."""
    n, h, w = d.shape
    valid = ((d >= CFG.min_dsp) & (d <= CFG.max_dsp)).flatten(1).sum(1).cpu()
    pairs = int((valid * existing_neighbours(n, offsets)).sum())
    return bound(8 * n * h * w + 84 * n, 25 * int(valid.sum()) + 88 * pairs)


def k2_bound(d, sk):
    """K2 reads the disparity once (plus cameras and centres) and writes
    29 B a sample; 25 flops per pixel it unprojects (each sample and its
    four +-1 neighbours, wrapped), 32 per sample (tangents, cross product,
    length, normalisation, flip) and 32 per sample and existing neighbour
    frame (projection, rounding, 1/z, the agreement test):
    csrc/sampling.cu."""
    n, h, w = d.shape
    r = sk["sample_radius"]
    ys, xs = torch.arange(0, h, r), torch.arange(0, w, r)
    need = torch.zeros(h, w, dtype=torch.bool)
    for dy, dx in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
        need[((ys + dy) % h)[:, None], ((xs + dx) % w)[None, :]] = True
    samples = len(ys) * len(xs)
    offs = [sg * k * sk["nbr_step"] for k in range(1, sk["nbr_num"] + 1)
            for sg in (-1, 1)]
    votes = samples * int(existing_neighbours(n, offs).sum())
    flops = 25 * n * int(need.sum()) + 32 * n * samples + 32 * votes
    return bound(4 * n * h * w + 96 * n + 29 * n * samples, flops)


def bbox_stats(uvz, faces, face_ok, h, w):
    """(longest side, pixels of the largest, pixels of all, live faces) of
    the clipped bboxes of the faces K3 bins, by the plain version's rule."""
    fl = faces.long()
    _, x0, x1, y0, y1, live = tr.clipped_bboxes(
        uvz[..., 0][:, fl], uvz[..., 1][:, fl], face_ok, height=h, width=w)
    bw = torch.where(live, x1 - x0 + 1, 0.0).long()
    bh = torch.where(live, y1 - y0 + 1, 0.0).long()
    return (int(torch.maximum(bw, bh).max()), int((bw * bh).max()),
            int((bw * bh).sum()), int(live.sum()))


def k3_bound(uvz, faces, face_ok, h, w, bbox_px, live):
    """K3 reads the projected vertices, faces and face mask and writes the
    z-buffer; ~40 flops per live face (setup) and ~15 per pixel of its
    clipped bbox (three edge functions)."""
    n_bytes = (uvz.numel() * 4 + faces.numel() * 4 + face_ok.numel() +
               uvz.shape[0] * h * w * 4)
    return bound(n_bytes, 40 * live + 15 * bbox_px)


def timed_record(name, run, plain, bound_ms, bound_by):
    """Kernel and plain ms, device us per CUDA kernel and the bound of one
    case, logged; returns the JSON record's timing fields."""
    ms, pms = time_ms(run), time_ms(plain)
    parts = kernel_breakdown(run)
    log(f"    {name}, device us per call: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) +
        f"; total {sum(parts.values()):.1f}")
    log(f"    {name}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by}), share of bound "
        f"{bound_ms / ms:.3f}")
    return dict(ms=ms, plain_ms=pms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def k12_case(name, d, cams, sk):
    """K1 and K2 against their plain versions on one size; returns their
    JSON records."""
    from multiviewstitch_tpu_torch.ops import consistency as tc
    from multiviewstitch_tpu_torch.ops import point_sampling as tps
    n, h, w = d.shape
    got = tc.check_consistency(d, cams, **K1_KW)
    ref = tc.check_consistency_reference(d, cams, **K1_KW)
    kept = int((ref > 0).sum())
    assert torch.equal(got, ref), \
        f"K1 {name}: {int((got != ref).sum())} pixels differ"
    assert kept > 0.3 * int((d > 0).sum()), f"K1 {name}: kept too little"
    log(f"K1 consistency, {name} {n}x{h}x{w}: bit-identical, kept {kept} "
        f"of {int((d > 0).sum())} valid pixels (of {d.numel()})")
    k1 = dict(max_abs_err=0.0, **timed_record(
        f"K1 {name}", lambda: tc.check_consistency(d, cams, **K1_KW),
        lambda: tc.check_consistency_reference(d, cams, **K1_KW),
        *k1_bound(d)))

    dc = got                          # the sampler reads K1's output
    kw = dict(min_dsp=CFG.min_dsp, max_dsp=CFG.max_dsp, **sk)
    op = tps.sample_oriented_points(dc, cams, **kw)
    rp = tps.sample_oriented_points_reference(dc, cams, **kw)
    assert torch.equal(op.points, rp.points), f"K2 {name}: points differ"
    conf_eq = (op.conf == rp.conf).float().mean().item()
    valid_eq = (op.valid == rp.valid).float().mean().item()
    both = op.valid & rp.valid
    nerr = (op.normals - rp.normals).abs().amax(-1)[both]
    n_ok = (nerr <= 1e-6).float().mean().item()
    err = max((op.conf - rp.conf).abs().max().item(), nerr.max().item())
    log(f"K2 oriented points, {name} {n}x{h}x{w} {sk}: points "
        f"bit-identical, conf equal on {conf_eq:.6f}, keep mask on "
        f"{valid_eq:.6f}, normals within 1e-6 on {n_ok:.6f} of "
        f"{int(both.sum())} kept samples (max normal error "
        f"{nerr.max().item():.3g}), kept {int(rp.valid.sum())} of "
        f"{rp.valid.numel()}")
    assert conf_eq >= 0.9999, f"K2 {name}: conf agreement {conf_eq}"
    assert valid_eq >= 0.9999, f"K2 {name}: keep-mask agreement {valid_eq}"
    assert n_ok >= 0.9999, f"K2 {name}: normals agreement {n_ok}"
    r = sk["sample_radius"]
    assert both.sum() > 0.1 * (dc[:, ::r, ::r] > 0).sum(), \
        f"K2 {name}: kept too little"
    k2 = dict(max_abs_err=err, **timed_record(
        f"K2 {name}", lambda: tps.sample_oriented_points(dc, cams, **kw),
        lambda: tps.sample_oriented_points_reference(dc, cams, **kw),
        *k2_bound(d, sk)))
    return k1, k2


# phase 3's K1 offsets case (the windowed filter's at halo 2)
K1_OFFSETS = (-2, -1, 1, 2)


def k1_offsets_case(name, d, cams):
    """K1 at K1_OFFSETS against its plain version: bit-identical, with
    kernel and plain ms, device us and the bound."""
    from multiviewstitch_tpu_torch.ops import consistency as tc
    kw = dict(K1_KW, offsets=K1_OFFSETS)
    got = tc.check_consistency(d, cams, **kw)
    ref = tc.check_consistency_reference(d, cams, **kw)
    assert torch.equal(got, ref), \
        f"K1 {name} offsets {K1_OFFSETS}: {int((got != ref).sum())} differ"
    log(f"K1 consistency, {name} {tuple(d.shape)} at offsets {K1_OFFSETS}: "
        f"bit-identical, kept {int((ref > 0).sum())} of "
        f"{int((d > 0).sum())} valid pixels")
    timed_record(f"K1 {name} offsets {K1_OFFSETS}",
                 lambda: tc.check_consistency(d, cams, **kw),
                 lambda: tc.check_consistency_reference(d, cams, **kw),
                 *k1_bound(d, K1_OFFSETS))


def phase_kernels(dev):
    """Each kernel against its plain version at the main path's shapes."""
    from multiviewstitch_tpu_torch.pipeline.fixtures import (make_scene,
                                                             uv_sphere,
                                                             ring_cameras)
    from multiviewstitch_tpu_torch.core.cameras import CameraBatch, _rot3
    from multiviewstitch_tpu_torch.core.transforms import inverse

    seqs, _, base, _ = config2_sequences(dev)
    rec = {}
    for name, n_frames, sk in K12_SIZES:
        if name == "config-2":
            d, cams = seqs[0].disparity, seqs[0].cams
        else:
            sc = make_scene(n_frames=n_frames, width=W, height=H, bumps=0.15,
                            n_lat=64, n_lon=96, arc_deg=45.0, device=dev)
            d, cams = sc.disparity, sc.cams
        k1, k2 = k12_case(name, d, cams, sk)
        if name == "long sequence":
            k1_offsets_case(name, d, cams)
        if name == "config-2":        # the main path's shapes
            rec["consistency"], rec["oriented_points"] = k1, k2
        del d, cams
        torch.cuda.empty_cache()

    def raster_case(name, verts, faces, rcams, h, w, main=False):
        uvz, fi, ok = tr.project_vertices(
            torch.as_tensor(verts, device=dev),
            torch.as_tensor(faces, device=dev),
            torch.ones(len(faces), dtype=torch.bool, device=dev), rcams)
        profiling.reset_counters(kernels.PAIRS)
        got = tr.raster(uvz, fi, ok, height=h, width=w)
        pairs = profiling.counters(kernels.PAIRS).get(kernels.PAIRS)
        ref = tr.raster_reference(uvz, fi, ok, height=h, width=w)
        n_diff = int(((got > 0) != (ref > 0)).sum())
        err = (got - ref).abs().max().item()
        assert (ref > 0).any(), f"K3 {name}: nothing rendered"
        assert torch.equal(got, ref), \
            f"K3 {name}: coverage diff {n_diff}, max abs err {err}"
        side, px, bbox_px, live = bbox_stats(uvz, fi, ok, h, w)
        log(f"K3 raster {name}: {len(faces)} faces x {uvz.shape[0]} frames "
            f"at {w}x{h}, largest clipped bbox {px} px (longest side "
            f"{side} px), {pairs} (face, tile) pairs, coverage diff "
            f"{n_diff}, max abs err {err}")
        times = timed_record(
            f"K3 {name}", lambda: tr.raster(uvz, fi, ok, height=h, width=w),
            lambda: tr.raster_reference(uvz, fi, ok, height=h, width=w),
            *k3_bound(uvz, fi, ok, h, w, bbox_px, live))
        if main:
            rec["raster"] = dict(max_abs_err=err, **times)
        return got, side

    raster_case("config-2 sphere", base.vertices, base.faces, base.cams, H,
                W, main=True)
    v100, f100 = uv_sphere(224, 224, bumps=0.15)
    raster_case("100k-face sphere", v100, f100,
                ring_cameras(N_FRAMES, width=W, img_height=H, arc_deg=45.0,
                             length_focal=500.0, device=dev), H, W)
    giant = np.asarray([[-20, -20, 2.0], [20, -20, 2.0], [20, 20, 2.0],
                        [-20, 20, 2.0]], np.float32)
    K = torch.tensor([[500.0, 0, (W - 1) / 2], [0, 500.0, (H - 1) / 2],
                      [0, 0, 1]], device=dev)
    gcam = CameraBatch(K[None], torch.eye(3, device=dev)[None],
                       torch.zeros(1, 3, device=dev), W, H)
    img, _ = raster_case("close-up giant faces", giant,
                         np.asarray([[0, 1, 2], [0, 2, 3]], np.int32), gcam,
                         H, W)
    assert torch.allclose(img, torch.full_like(img, 0.5), atol=1e-5)
    vr, fr = uv_sphere(224, 224, radius=0.8)
    vr[:, 2] += 2.5
    _, side = raster_case("close-up ring", vr, fr, ring_cameras(
        8, radius=2.5, width=W, img_height=H, length_focal=520.0,
        arc_deg=90.0, arc_center_deg=CLOSE_UP_ARC_CENTER_DEG, device=dev),
        H, W)
    assert side > 128, f"close-up ring: no giant face (longest side {side})"
    # phase 8's two shapes: the body drawn through inverse(gt) into the
    # first sequence's 12 portrait frames, as ``render --config`` draws
    # deform.obj, and render_bench's config-3 ring
    (_, tf, _), posed, bcams = body_ring(dev)
    inv = inverse(body_transform())
    raster_case("body ring", _rot3(inv.R, torch.as_tensor(posed)) * inv.s
                + inv.t, tf, bcams, BODY_H, BODY_W)
    raster_case("config-3 ring", *config3_scene(dev), H, W)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rec["stencil"] = stencil_case(dev)
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def k4_off():
    """ops.poisson's plain code on CUDA tensors: K4's plain version."""
    from multiviewstitch_tpu_torch.ops import poisson as P
    on = P._on_k4
    P._on_k4 = lambda t: False
    try:
        yield
    finally:
        P._on_k4 = on


def plain_poisson(fn):
    def run():
        with k4_off():
            return fn()
    return run


def stencil_case(dev):
    """K4 at the scan's 1024^3 against the plain code of ops/poisson, bit
    for bit: one Jacobi sweep, one V-cycle from x = 0 (levels 1024..32 and
    the 16^3 solve) and one box-blur pass along each axis. Returns the
    sweep's JSON record with the V-cycle's times beside it."""
    from multiviewstitch_tpu_torch.ops import poisson as P
    g, screen = STENCIL_SIDE, 1e-3
    cells = g ** 3
    gen = torch.Generator(device=dev).manual_seed(0)
    b = P._box_blur_(torch.randn((g,) * 3, generator=gen, device=dev))
    x = torch.randn((g,) * 3, generator=gen, device=dev)
    out = kernels.stencil_jacobi(x, b, torch.empty_like(x), screen=screen,
                                 omega=0.8)
    with k4_off():
        want = P._smooth_jacobi(x.clone(), b, screen, 1)
    assert torch.equal(out, want), "K4 sweep differs from the plain code"
    del want
    xp = x.clone()
    sweep = timed_record(
        f"K4 Jacobi sweep {g}^3",
        lambda: kernels.stencil_jacobi(x, b, out, screen=screen, omega=0.8),
        plain_poisson(lambda: P._smooth_jacobi(xp, b, screen, 1)),
        *bound(12 * cells, 13 * cells))
    for ax in range(3):
        got = kernels.stencil_box_blur(x, out, axis=ax)
        with k4_off():
            want = x.clone()
            P._acc_roll(want, x, 1, ax)
            P._acc_roll(want, x, -1, ax)
            want.div_(3.0)
        assert torch.equal(got, want), f"K4 blur along axis {ax} differs"
        del want

        def blur_plain(ax=ax):
            xp.copy_(x)
            P._acc_roll(xp, x, 1, ax)
            P._acc_roll(xp, x, -1, ax)
            xp.div_(3.0)
        timed_record(f"K4 box blur {g}^3 axis {ax}",
                     lambda ax=ax: kernels.stencil_box_blur(x, out, axis=ax),
                     blur_plain, *bound(8 * cells, 3 * cells))
    del x, xp, out
    torch.cuda.empty_cache()
    xk = P._vcycle(torch.zeros_like(b), b, screen)
    with k4_off():
        xq = P._vcycle(torch.zeros_like(b), b, screen)
    assert torch.equal(xk, xq), "K4 V-cycle differs from the plain code"
    del xq
    torch.cuda.empty_cache()
    # each launch reads its inputs once and writes its outputs once: per
    # level 4 sweeps (12 B a cell), the restricted residual (8.5 B) and
    # the prolongation (8.5 B); the 16^3 solve is 32 KB
    vbytes = sum(65 * (g >> lv) ** 3 for lv in range(6))
    before = kernels.launch_counts()["stencil"]
    P._vcycle(xk, b, screen)
    torch.cuda.synchronize()
    n = kernels.launch_counts()["stencil"] - before
    assert n == 6 * 6 + 1, f"a 1024^3 V-cycle launched K4 {n} times"
    vc = timed_record(
        f"K4 V-cycle {g}^3 ({n} launches)",
        lambda: P._vcycle(xk, b, screen),
        plain_poisson(lambda: P._vcycle(xk, b, screen)),
        *bound(vbytes, 20 * cells * 8 / 7))
    return dict(max_abs_err=0.0, vcycle_ms=vc["ms"],
                vcycle_plain_ms=vc["plain_ms"],
                vcycle_bound_ms=vc["bound_ms"], **sweep)


def rmse_to(points, verts, dev):
    p = torch.as_tensor(points, device=dev)
    v = torch.as_tensor(verts, device=dev)
    d2 = torch.cat([torch.cdist(c, v).min(1).values ** 2
                    for c in p.split(8192)])
    return float(d2.mean().sqrt())


def synced_timer(t, outs=None):
    """A ``run_align`` stage hook that stores each stage's synced wall
    seconds in ``t`` (and, with ``outs``, its output)."""
    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        if outs is not None:
            outs[name] = out
        return out
    return stage


def noisy(seqs, level):
    """The sequences under fixtures.sensor_noise at ``level`` (seed k for
    sequence k, as the JAX noise test draws), on their device."""
    from multiviewstitch_tpu_torch.pipeline.align_seq import Sequence
    from multiviewstitch_tpu_torch.pipeline.fixtures import sensor_noise
    out = []
    for k, s in enumerate(seqs):
        g, d = sensor_noise(s.gray.cpu().numpy(), s.disparity.cpu().numpy(),
                            level, seed=k)
        dev = s.gray.device
        out.append(Sequence(torch.as_tensor(g, device=dev),
                            torch.as_tensor(d, device=dev), s.cams))
    return out


def run_slice(dev, workdir, arc_center_deg=0.0, stage=None, noise=0.0,
              refine=False, outs=None):
    """The config-2 align slice through the port's entry points (under
    sensor noise at ``noise``, refined by ``refine``); returns (stage
    seconds, gt, result, points, normals, moved scene, mesh)."""
    t = {}
    stage = stage or synced_timer(t, outs)
    seqs, gt, _, moved = stage("render_s",
                               lambda: config2_sequences(dev,
                                                         arc_center_deg))
    if noise:
        seqs = noisy(seqs, noise)
    res, pts, nrm, v, f = run_align(seqs, CFG, GRID, workdir, stage,
                                    refine=refine)
    t["total_s"] = sum(t.values())
    return t, gt, res, pts, nrm, moved, (v, f)


# the similarity limits: test_e2e_align's, and the JAX noise test's
# (tests/test_noise_robustness.py:31-42) for noisy input
HARD = (0.05, 3.0, 0.08)
NOISE = (0.08, 5.0, 0.15)


def similarity_errors(T, gt, gt_s):
    """(relative scale error, rotation error in degrees, translation
    error) of T against gt."""
    from multiviewstitch_tpu_torch.core.transforms import rotation_angle_deg
    return (abs(float(T.s) - gt_s) / gt_s, rotation_angle_deg(T.R, gt.R),
            float(np.linalg.norm(T.t.numpy() - gt.t.numpy())))


def check_similarity(name, T, gt, gt_s, limits=HARD):
    s_err, ang, t_err = similarity_errors(T, gt, gt_s)
    assert s_err <= limits[0], f"{name}: scale {float(T.s)} vs {gt_s}"
    assert ang < limits[1], f"{name}: rotation error {ang} deg"
    assert t_err < limits[2], f"{name}: translation error {t_err}"


def check_slice(name, dev, gt, res, pts, nrm, moved, mesh, limits=HARD):
    T = res.transforms[0]
    _, ang, t_err = similarity_errors(T, gt, GT_S)
    rmse = rmse_to(pts, moved.vertices, dev)
    v, f = mesh
    log(f"slice {name}: s {float(T.s):.5f} (gt {GT_S}), rotation error "
        f"{ang:.4f} deg, translation error {t_err:.5f}, keyframes "
        f"{res.keyframes}, residual {res.residuals[0]:.5f}, fused points "
        f"{len(pts)}, fused RMSE {rmse:.5f}, mesh {len(v)} verts / "
        f"{len(f)} faces")
    check_similarity(name, T, gt, GT_S, limits)
    assert len(pts) > 2000 and np.isfinite(pts).all() and \
        np.isfinite(nrm).all()
    assert rmse < 0.05, f"{name}: fused-cloud RMSE {rmse}"
    assert len(v) > 500 and len(f) > 500


def phase_slice(dev):
    with tempfile.TemporaryDirectory() as warm_dir:
        run_slice(dev, warm_dir)                     # warm-up
    with tempfile.TemporaryDirectory() as wd:
        kernels.reset_launch_counts()
        t, gt, res, pts, nrm, moved, mesh = run_slice(dev, wd)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        for name in ("SRT.txt", "PSR.npts", "Model.obj"):
            assert os.path.getsize(os.path.join(wd, name)) > 0, name
    check_slice("config-2", dev, gt, res, pts, nrm, moved, mesh)
    for name in SLICE_KERNELS:
        assert launches[name] > 0, f"{name} was not launched by the slice"
    log("slice stage wall times (warm, synced): " + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items()))
    log(f"launches during the slice: {launches}")
    with tempfile.TemporaryDirectory() as wd:
        t, gt, res, pts, nrm, moved, mesh = run_slice(dev, wd,
                                                      ARC_CENTER_DEG)
    check_slice(f"config-2, second arc centred at {ARC_CENTER_DEG} deg", dev,
                gt, res, pts, nrm, moved, mesh)
    assert res.residuals[0] > 0, "turned arc: the solve should not be exact"
    log("turned-arc stage wall times (warm, synced): " + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items()))
    return launches


# phase 4's noisy and refined runs: (name, sensor-noise level, second arc's
# centre, refine)
NOISE_REFINE_RUNS = (
    ("noise 1x", 1.0, 0.0, False),
    ("noise 2x", 2.0, 0.0, False),
    ("turned arc, pose graph", 0.0, ARC_CENTER_DEG, "pose_graph"),
    ("turned arc, BA", 0.0, ARC_CENTER_DEG, "ba"),
    ("noise 1x, BA", 1.0, 0.0, "ba"),
)


def phase_noise_refine(dev):
    """config-2 under sensor noise and with each refinement, through
    run_align; every run drives K1-K3 from zeroed launch counts."""
    for name, level, arc, refine in NOISE_REFINE_RUNS:
        outs = {}
        with tempfile.TemporaryDirectory() as wd:
            kernels.reset_launch_counts()
            t, gt, res, pts, nrm, moved, mesh = run_slice(
                dev, wd, arc, noise=level, refine=refine, outs=outs)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
        for k in SLICE_KERNELS:
            assert launches[k] > 0, f"{name}: {k} was not launched"
        check_slice(name, dev, gt, res, pts, nrm, moved, mesh,
                    NOISE if level else HARD)
        m = res.metrics
        if refine == "ba":
            assert m["ba_rmse_px"] <= m["ba_rmse_init_px"], m
        if refine:
            assert "refine_s" in t, t
        n_tsdf = len(outs["tsdf_s"][0])
        log(f"slice {name}: refine {refine}, metrics {m}; TSDF mesh "
            f"{n_tsdf} vertices before the trim (the JAX package keeps at "
            f"most 65,536); launches {launches}; stage wall times (warm, "
            "synced): " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))


# the profiler ranges of ops/poisson.reconstruct_poisson's step spans
POISSON_STEPS = ("mvs.poisson.field", "mvs.poisson.dilate",
                 "mvs.poisson.extract")


def device_events(prof):
    """The device-side events (kernels, memcpys, memsets) of a profile,
    without the device-side copies of the spans' ranges."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(profiling.RANGE_PREFIX)]


def device_busy_us(prof):
    """(busy us, event count): the union of the device-side (kernel,
    memcpy, memset) events' intervals of one profiled region."""
    iv = sorted((e.time_range.start, e.time_range.end)
                for e in device_events(prof))
    busy, end = 0.0, float("-inf")
    for a, b in iv:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, len(iv)


def top_device_events(prof, n=5):
    """The ``n`` device-side events of a profile with the most time."""
    by_name = {}
    for e in device_events(prof):
        us, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return "; ".join(f"{nm[:60]} {us / 1e3:.3f} ms x{k}"
                     for nm, (us, k) in top)


def phase_profile(dev):
    """Each stage of the warm config-2 slice under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    rows = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, n = device_busy_us(prof)
        rows[name] = (wall, busy, n, prof)
        return out

    with tempfile.TemporaryDirectory() as wd:
        run_slice(dev, wd, stage=stage)
    tot_wall = sum(r[0] for r in rows.values())
    tot_busy = sum(r[1] for r in rows.values())
    assert tot_busy > 0, "the profiler saw no device-side events"
    for name, (wall, busy, n, prof) in rows.items():
        log(f"profile {name}: wall {wall * 1e3:.3f} ms (profiled), device "
            f"busy {busy / 1e3:.3f} ms ({100 * busy / 1e6 / wall:.1f} %), "
            f"{n} device events")
        log("    top device events: " + top_device_events(prof))
    log(f"profile total: wall {tot_wall:.4f} s (profiled), device busy "
        f"{tot_busy / 1e6:.4f} s ({100 * tot_busy / 1e6 / tot_wall:.1f} %)")


def phase_cli():
    from multiviewstitch_tpu_torch.cli import main
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        rc = main(["align", "--demo", "--device", "cuda", "--workdir", wd,
                   "--force"])
        assert rc == 0, f"cli align returned {rc}"
        for name in ("SRT.txt", "PSR.npts", "Model.obj"):
            assert os.path.getsize(os.path.join(wd, "Result", name)) > 0
    log(f"cli align --demo --device cuda: rc 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as wd:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = main(["align", "--demo", "--refine", "ba", "--debug-artifacts",
                   "--device", "cuda", "--workdir", wd, "--force"])
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        assert rc == 0, f"cli align --refine ba returned {rc}"
        pngs = sorted(f for f in os.listdir(os.path.join(wd, "Match"))
                      if f.endswith(".png"))
        assert len(pngs) == 1, pngs
        for k in ("consistency", "oriented_points"):
            assert launches[k] > 0, f"align --refine ba: {k} not launched"
    log(f"cli align --demo --refine ba --debug-artifacts --device cuda: rc 0 "
        f"in {time.perf_counter() - t0:.2f} s, Match/{pngs[0]}, launches "
        f"{launches}")
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        rc = main(["pipeline", "--demo", "--device", "cuda", "--workdir", wd,
                   "--force"])
        assert rc == 0, f"cli pipeline returned {rc}"
        for name in ("SRT.txt", "PSR.npts", "Model.obj", "deform.obj"):
            assert os.path.getsize(os.path.join(wd, "Result", name)) > 0
        rdir = os.path.join(wd, "DATA", "Render")
        raws = sorted(f for f in os.listdir(rdir) if f.endswith(".raw"))
        assert raws == [f"_depth{i}.raw" for i in range(4)], raws
        for f in raws:
            assert os.path.getsize(os.path.join(rdir, f)) == 160 * 120 * 4
    log(f"cli pipeline --demo --device cuda: rc 0 in "
        f"{time.perf_counter() - t0:.2f} s (SRT.txt, PSR.npts, Model.obj, "
        f"deform.obj, {len(raws)} rasters)")


# config-2's knobs (cli.demo_config()) as the reference's legacy config.txt;
# max_keypoints has no legacy key and goes in as --set
CONFIG_TXT = """# config-2: two sequences of five VGA frames
ImgPathList ./imgPathList.txt
ViewCount 1 MinMatchCount 7 IterNum 256 SampleIterval 4 SSDWin 3
SSDError 40.0 ReprojError 4 PixelError 12.0 AdtPxlErrRatio 0.6
HLMarginRatio 0.02 HRMarginRatio 0.02 VLMarginRatio 0.02 VRMarginRatio 0.02
MinDsp 0.001 MaxDsp 10.0 NbrFrmNum 1 MinConf 0.5 MaxDspErr 0.05
"""
# Poisson depths of phase 7's two passes: None keeps the config's PsnDptMax
# (10, the StitchConfig default); the second pass is the warm 256^3 one
CONFIG_DEPTHS = (None, 8)


def write_config_layout(dev, root):
    """The config-2 scene in the reference's layout under ``root``;
    returns (config.txt path, gt, moved scene)."""
    from multiviewstitch_tpu_torch.pipeline.ingest import save_sequence_dir
    seqs, gt, _, moved = config2_sequences(dev)
    for k, seq in enumerate(seqs):
        save_sequence_dir(os.path.join(root, f"seq{k}"), seq)
    with open(os.path.join(root, "imgPathList.txt"), "w") as f:
        f.write("./seq0/\n./seq1/\n")
    path = os.path.join(root, "config.txt")
    with open(path, "w") as f:
        f.write(CONFIG_TXT)
    return path, gt, moved


def config_run(dev, config, workdir, depth, profile_poisson=False):
    """``align --config`` through cli.main with every flag of the slice;
    returns (stage seconds and the Poisson stage's peak GB, stage
    outputs, the Poisson stage's torch.profiler profile or None)."""
    from torch.profiler import ProfilerActivity, profile
    from multiviewstitch_tpu_torch.cli import main
    t, outs, profs = {}, {}, []

    def stage(name, fn):
        torch.cuda.synchronize()
        poisson = name == "poisson_s"
        if poisson:
            torch.cuda.reset_peak_memory_stats()
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
                if poisson and profile_poisson else contextlib.nullcontext())
        with prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t[name] = time.perf_counter() - t0
        if poisson:
            t["poisson_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if profile_poisson:
                profs.append(prof)
        outs[name] = out
        return out
    argv = ["align", "--config", config, "--workdir", workdir, "--backend",
            "poisson", "--write-mesh", "--set", "segment=true", "--set",
            "all_seq_proj=true", "--set", "max_keypoints=512", "--device",
            str(dev), "--force"]
    if depth is not None:
        argv += ["--set", f"psn_dpt_max={depth}"]
    with (profiling.recording() if profile_poisson
          else contextlib.nullcontext()):
        rc = main(argv, stage=stage)
    assert rc == 0, f"cli align --config returned {rc}"
    return t, outs, (profs[0] if profs else None)


def check_config_run(name, dev, wd, gt, moved, t):
    """SRT.txt against gt, PSR.npts, Model.obj against the moved surface
    and the per-frame meshes of one config run; returns the mesh size."""
    from multiviewstitch_tpu_torch.core.transforms import rotation_angle_deg
    from multiviewstitch_tpu_torch.io.meshio import read_npts, read_obj
    from multiviewstitch_tpu_torch.io.srt import load_srt
    res = os.path.join(wd, "Result")
    T = load_srt(os.path.join(res, "SRT.txt"))[0]
    s_err = abs(float(T.s) - GT_S) / GT_S
    ang = rotation_angle_deg(T.R, gt.R)
    t_err = float(np.linalg.norm(T.t.numpy() - gt.t.numpy()))
    pts, nrm = read_npts(os.path.join(res, "PSR.npts"))
    v, _, f = read_obj(os.path.join(res, "Model.obj"))
    rmse = rmse_to(v, moved.vertices, dev) if len(v) else float("inf")
    models = sorted(os.listdir(os.path.join(wd, "Models")))
    log(f"config {name}: s {float(T.s):.5f} (gt {GT_S}), rotation error "
        f"{ang:.4f} deg, translation error {t_err:.5f}; PSR.npts {len(pts)} "
        f"points; Model.obj {len(v)} verts / {len(f)} faces, vertex RMSE to "
        f"the true surface {rmse:.5f}; {len(models)} per-frame meshes")
    log(f"config {name} stage wall times (synced): " + ", ".join(
        f"{k} {x:.4f}" for k, x in t.items() if k.endswith("_s")) +
        f"; total {sum(x for k, x in t.items() if k.endswith('_s')):.4f} s; "
        f"Poisson peak device memory {t['poisson_peak_gb']:.3f} GB")
    assert s_err <= 0.05, f"config {name}: scale {float(T.s)} vs {GT_S}"
    assert ang < 3.0, f"config {name}: rotation error {ang} deg"
    assert t_err < 0.08, f"config {name}: translation error {t_err}"
    assert len(pts) > 2000 and np.isfinite(pts).all() and \
        np.isfinite(nrm).all(), f"config {name}: PSR.npts"
    assert len(v) > 500 and rmse < 0.05, \
        f"config {name}: Model.obj {len(v)} verts, RMSE {rmse}"
    assert models == sorted(f"model{k}_{i}.obj" for k in range(2)
                            for i in range(N_FRAMES)), models
    return len(v), len(f)


def exact_largest_component(verts, faces):
    """Vertex count of the mesh's largest edge-connected component, by
    scipy's connected_components (independent of solvers/unionfind)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    n = len(verts)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    _, comp = connected_components(coo_matrix(
        (np.ones(len(e), np.int8), (e[:, 0], e[:, 1])), shape=(n, n)),
        directed=False)
    face_comp = comp[faces[:, 0]]
    best = np.bincount(face_comp).argmax()
    return int(np.unique(faces[face_comp == best]).size)


def log_poisson_profile(prof, wall, depth):
    """Device busy share of a profiled Poisson stage, and each step's host
    span and the device time of the kernels it launched (its
    profiler range)."""
    busy, n = device_busy_us(prof)
    log(f"profile poisson_s at depth {depth}: wall {wall:.4f} s "
        f"(profiled), device busy {busy / 1e6:.4f} s "
        f"({100 * busy / 1e6 / wall:.1f} %), {n} device events")
    steps = {e.name: e for e in prof.events()
             if e.name in POISSON_STEPS
             and e.device_type == torch.autograd.DeviceType.CPU}
    log(f"poisson_s steps at depth {depth} (host span s / device s): " +
        ", ".join(f"{k} {steps[k].time_range.elapsed_us() / 1e6:.4f} / "
                  f"{steps[k].device_time_total / 1e6:.4f}"
                  for k in POISSON_STEPS if k in steps))
    # a range's device time counts the PyTorch ops launched inside it;
    # K4's ctypes launches link to no op, and run only inside the field
    k4 = sum(e.time_range.elapsed_us() for e in device_events(prof)
             if "stencil_" in e.name)
    log(f"    K4 device s (the field's, besides its PyTorch ops): "
        f"{k4 / 1e6:.4f}")
    log("    top device events: " + top_device_events(prof))
    assert busy > 0, "the profiler saw no device-side Poisson events"


def phase_config(dev):
    """``align --config`` on the reference's on-disk layout with Poisson
    at the default depth 10, segment, AllSeqProj and per-frame meshes."""
    from multiviewstitch_tpu_torch.io import native_loader
    with tempfile.TemporaryDirectory() as root:
        config, gt, moved = write_config_layout(dev, root)
        wd = os.path.join(root, "work10")
        kernels.reset_launch_counts()
        native_loader.reset_read_counts()
        t, outs, prof = config_run(dev, config, wd, CONFIG_DEPTHS[0],
                                   profile_poisson=True)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        reads = native_loader.read_counts()
        log(f"launches during the config run: {launches}; raw depth batches "
            f"read by the ingest: {reads}")
        assert reads == {"native": 2, "numpy": 0}, \
            f"ingest did not read through the native library: {reads}"
        n_v, _ = check_config_run("PsnDptMax 10 (Poisson 1024^3; poisson_s "
                                  "profiled)", dev, wd, gt, moved, t)
        n_exact = exact_largest_component(*outs["all_seq_proj_s"][:2])
        log(f"config PsnDptMax 10: Model.obj {n_v} verts, the exact largest "
            f"component of the reconstructed mesh {n_exact} verts (scipy); "
            f"trim_write_s {t['trim_write_s']:.4f} s")
        assert n_v == n_exact, (n_v, n_exact)
        for k in ("consistency", "oriented_points"):
            assert launches[k] > 0, f"{k} was not launched by align --config"
        assert launches["stencil"] == SCAN_STENCIL_LAUNCHES, \
            f"K4 launches {launches['stencil']}, not {SCAN_STENCIL_LAUNCHES}"
        log_poisson_profile(prof, t["poisson_s"],
                            CONFIG_DEPTHS[0] or 10)
        depth = CONFIG_DEPTHS[1]
        wd = os.path.join(root, f"work{depth}")
        t8, _, _ = config_run(dev, config, wd, depth)
        check_config_run(f"psn_dpt_max {depth} (Poisson {1 << depth}^3, "
                         "warm)", dev, wd, gt, moved, t8)
        from multiviewstitch_tpu_torch.solvers.unionfind import (
            retain_largest_component)
        t0 = time.perf_counter()
        kv, kf, _ = retain_largest_component(*outs["all_seq_proj_s"][:2])
        log(f"largest component of the depth-10 mesh: "
            f"{len(outs['all_seq_proj_s'][0])} -> {len(kv)} verts, "
            f"{len(kf)} faces in {time.perf_counter() - t0:.4f} s (host; "
            f"the rest of trim_write_s is writing)")
    return launches["stencil"]

# phase 8: bench/body_bench.py's body scan (the reference's second mode)
BODY_W, BODY_H, BODY_FRAMES, BODY_GRID = 480, 640, 12, 160
BODY_S, BODY_YAW_DEG, BODY_T = 1.12, 9.0, (0.12, -0.06, 0.1)
# the card test's bound on deform, card vs CPU (tests/test_torch_gpu.py)
DEFORM_GAP_MAX = 1e-3
# the config-3 loop (bench/render_bench.py:122-150): outer iterations timed
LOOP_ITERS = 5


def body_transform():
    from multiviewstitch_tpu_torch.core.transforms import Similarity
    a = np.radians(BODY_YAW_DEG)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    return Similarity(torch.tensor(BODY_S), torch.as_tensor(R),
                      torch.tensor(BODY_T, dtype=torch.float32))


def body_ring(dev):
    """body_bench's posed template (arms 15, legs 5 degrees) and its full
    ring of portrait cameras framing it to ~45 % of the frame. Returns
    (template, posed vertices, cameras)."""
    from multiviewstitch_tpu_torch.models.template_body import (
        make_template, pose_template)
    from multiviewstitch_tpu_torch.pipeline.fixtures import ring_cameras
    tv, tf, tl = make_template()
    posed = pose_template(tv, tl, arm_angle_deg=15.0,
                          leg_spread_deg=5.0).astype(np.float32)
    center = posed.mean(0)
    cams = ring_cameras(BODY_FRAMES, radius=2.8, width=BODY_W,
                        img_height=BODY_H,
                        length_focal=float(0.25 * BODY_H * 2.8 / 1.8),
                        look_at=tuple(center.tolist()),
                        height=float(center[1]), device=dev)
    return (tv, tf, tl), posed, cams


def body_sequences(dev):
    """body_bench's two sequences of the body ring, the second through
    body_transform(). Returns (sequences, gt, template, the second scene's
    body)."""
    from multiviewstitch_tpu_torch.pipeline.align_seq import Sequence
    from multiviewstitch_tpu_torch.pipeline.fixtures import (
        mesh_scene, textured_views)
    (tv, tf, tl), posed, cams = body_ring(dev)
    gt = body_transform()
    scenes = [mesh_scene(posed, tf, cams), mesh_scene(posed, tf, cams, gt)]
    seqs = [Sequence(textured_views(sc), sc.disparity, sc.cams)
            for sc in scenes]
    return seqs, gt, (tv, tf, tl), scenes[1].vertices


def write_body_layout(dev, root):
    """The body sequences in the reference's layout under ``root``, with
    config-2's knobs (body_bench's align config); returns (config.txt,
    sequences, gt, template, body)."""
    from multiviewstitch_tpu_torch.pipeline.ingest import save_sequence_dir
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs, gt, tmpl, body = body_sequences(dev)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    assert kernels.launch_counts()["raster"] == 2, kernels.launch_counts()
    for k, seq in enumerate(seqs):
        save_sequence_dir(os.path.join(root, f"seq{k}"), seq)
    with open(os.path.join(root, "imgPathList.txt"), "w") as f:
        f.write("./seq0/\n./seq1/\n")
    config = os.path.join(root, "config.txt")
    with open(config, "w") as f:
        f.write(CONFIG_TXT)
    cover = [float((s.disparity > 0).float().mean()) for s in seqs]
    log(f"body: 2 x {BODY_FRAMES} frames at {BODY_W}x{BODY_H} rendered by "
        f"K3 in {t_render:.4f} s (coverage {cover[0]:.4f} / {cover[1]:.4f})")
    return config, seqs, gt, tmpl, body


def body_align(dev, config, wd, seqs, gt, body):
    """``align --config --refine ba`` of the body (body_bench's flow,
    bench/body_bench.py:141-165) through cli.main, held to the hard limits;
    and the scan fused through the true similarity as a control. Returns
    the aligned similarity and the run's Model.obj (vertices, faces)."""
    from multiviewstitch_tpu_torch.cli import main
    from multiviewstitch_tpu_torch.core.transforms import Similarity
    from multiviewstitch_tpu_torch.io.meshio import read_obj
    from multiviewstitch_tpu_torch.io.srt import load_srt
    from multiviewstitch_tpu_torch.ops.tsdf import fuse_multi_sequence
    from multiviewstitch_tpu_torch.solvers.unionfind import (
        retain_largest_component)
    t, outs = {}, {}
    kernels.reset_launch_counts()
    rc = main(["align", "--config", config, "--workdir", wd, "--refine", "ba",
               "--grid", str(BODY_GRID), "--set", "max_keypoints=512",
               "--device", str(dev), "--force"], stage=synced_timer(t, outs))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    assert rc == 0, f"cli align --config --refine ba (body) returned {rc}"
    for k in ("consistency", "oriented_points"):
        assert launches[k] > 0, f"body align: {k} was not launched"
    T = load_srt(os.path.join(wd, "Result", "SRT.txt"))[0]
    s_err, ang, t_err = similarity_errors(T, gt, BODY_S)
    m = outs["refine_s"].metrics
    sv, _, sf = read_obj(os.path.join(wd, "Result", "Model.obj"))
    log(f"body align --refine ba: s {float(T.s):.5f} (gt {BODY_S}, error "
        f"{s_err:.5f}), rotation error {ang:.4f} deg, translation error "
        f"{t_err:.5f}; BA {m}; scan (Model.obj) {len(sv)} vertices / "
        f"{len(sf)} faces, vertex RMSE to the body "
        f"{rmse_to(sv, body, dev):.5f}; launches {launches}")
    log("body align stage wall times (synced): " + ", ".join(
        f"{k} {x:.4f}" for k, x in t.items()) +
        f"; total {sum(t.values()):.4f} s")
    check_similarity("body align", T, gt, BODY_S)
    assert m["ba_rmse_px"] <= m["ba_rmse_init_px"], m
    cv, cf, _ = fuse_multi_sequence(
        [s.disparity for s in seqs], [s.cams for s in seqs],
        [gt, Similarity.identity(device="cpu")], grid=BODY_GRID,
        min_dsp=1e-3, max_dsp=10.0)
    cv, cf, _ = retain_largest_component(cv, cf)
    log(f"body control, the scan fused through the true similarity: "
        f"{len(cv)} vertices, vertex RMSE to the body "
        f"{rmse_to(cv, body, dev):.5f}")
    return T, (sv, sf)


def deform_run(dev, wd, profiled=False):
    """``cli deform`` on ``wd``; returns (stage seconds, deform_s's
    torch.profiler profile or None, vertices)."""
    from torch.profiler import ProfilerActivity, profile
    from multiviewstitch_tpu_torch.cli import main
    from multiviewstitch_tpu_torch.io.meshio import read_obj
    t, profs = {}, []
    timed = synced_timer(t)

    def stage(name, fn):
        if not (profiled and name == "deform_s"):
            return timed(name, fn)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = timed(name, fn)
        profs.append(prof)
        return out
    rc = main(["deform", "--workdir", wd, "--device", str(dev)], stage=stage)
    assert rc == 0, f"cli deform --device {dev} returned {rc}"
    v, n, f = read_obj(os.path.join(wd, "Result", "deform.obj"))
    assert len(n) == len(v) and np.isfinite(v).all()
    return t, (profs[0] if profs else None), v


def log_deform_steps(dev, verts, faces, sv, sf):
    """CUDA-event times of a deform pass's two device steps at the body's
    shapes: the [C,T] correspondence search of the template's controls in
    the scan, and the 5-iteration ARAP solve (dense Cholesky path); and
    the synced wall time of the rigid alignment's ground removal. Returns
    the ARAP problem (phase 10 solves it sharded)."""
    from multiviewstitch_tpu_torch.ops.mesh_normals import vertex_normals
    from multiviewstitch_tpu_torch.solvers import deformation as D
    from multiviewstitch_tpu_torch.solvers.alignment import remove_ground
    from multiviewstitch_tpu_torch.solvers.unionfind import (
        retain_largest_component)
    sidx = D.uniform_sampling(verts)
    edges = D.mesh_edges(faces)
    w = D.cotangent_weights(verts, faces, edges)
    vt = torch.as_tensor(verts, device=dev)
    ft = torch.as_tensor(faces.astype(np.int64), device=dev)
    st = torch.as_tensor(sv, device=dev)
    sn = vertex_normals(st, torch.as_tensor(sf.astype(np.int64), device=dev))
    si = torch.as_tensor(sidx, device=dev)
    controls, cn = vt[si], vertex_normals(vt, ft)[si]
    corr = D.find_correspondences(controls, cn, st, sn)
    targets = vt.clone()
    targets[si] = corr.targets
    con = torch.zeros(len(verts), dtype=torch.bool, device=dev)
    con[si] = True
    prob = D.ARAPProblem(vt, torch.as_tensor(edges.astype(np.int64),
                                             device=dev),
                         torch.as_tensor(w, device=dev), con, targets)
    ms_c = time_ms(lambda: D.find_correspondences(controls, cn, st, sn),
                   reps=10)
    ms_a = time_ms(lambda: D.arap_solve(prob), reps=10)
    log(f"body deform steps (CUDA events, median of 10): "
        f"find_correspondences {len(sidx)} controls x {len(sv)} scan "
        f"points {ms_c:.3f} ms, arap_solve ({len(verts)} vertices, "
        f"{len(edges)} edges, dense, 5 outer iterations) {ms_a:.3f} ms; "
        f"{int(corr.valid.sum())} controls accepted")
    # the rigid alignment's first step, and the host pass inside it
    t = {}
    timed = synced_timer(t)
    g = timed("remove_ground_s", lambda: remove_ground(sv, None, sf,
                                                       device=dev))
    timed("largest_component_s", lambda: retain_largest_component(sv, sf))
    log(f"body rigid alignment steps (synced): remove_ground "
        f"{t['remove_ground_s']:.4f} s ({len(sv)} -> {len(g.points)} "
        f"vertices), the host largest-component pass over the whole scan "
        f"{t['largest_component_s']:.4f} s")
    return prob


def phase_body(dev):
    """The reference's second mode on the body scan: deform and render on
    the card, deform on the CPU, the control render and the config-3
    loop. Returns the body's ARAP problem."""
    import shutil
    from multiviewstitch_tpu_torch.cli import main
    from multiviewstitch_tpu_torch.core.transforms import Similarity
    from multiviewstitch_tpu_torch.pipeline.deform_render import render_stage
    with tempfile.TemporaryDirectory() as root:
        config, seqs, gt, (tv, tf, _), body = write_body_layout(dev, root)
        wd = os.path.join(root, "work")
        T, (sv, sf) = body_align(dev, config, wd, seqs, gt, body)
        runs = [deform_run(dev, wd) for _ in range(2)]
        t_p, prof, v = deform_run(dev, wd, profiled=True)
        for name, (t, _, v_run) in zip(("cold", "warm"), runs):
            log(f"body deform ({name}, synced): " + ", ".join(
                f"{k} {x:.4f}" for k, x in t.items()) +
                f"; max abs to the profiled run's "
                f"{np.abs(v_run - v).max():.3g}")
        fit, to_body = rmse_to(v, sv, dev), rmse_to(v, body, dev)
        busy, n_ev = device_busy_us(prof)
        log(f"body deform (warm, deform_s profiled): deform_s "
            f"{t_p['deform_s']:.4f} s, device busy {busy / 1e6:.4f} s "
            f"({100 * busy / 1e6 / t_p['deform_s']:.1f} %), {n_ev} device "
            f"events; deform.obj {len(v)} vertices, fit RMS to the scan "
            f"{fit:.5f}, RMS to the posed, moved body {to_body:.5f}")
        log("    top device events: " + top_device_events(prof))
        assert len(v) == len(tv), (len(v), len(tv))
        assert fit < 0.06, f"body deform: fit RMS to the scan {fit}"
        arap_prob = log_deform_steps(dev, v, tf, sv, sf)

        wd_cpu = os.path.join(root, "work_cpu")
        shutil.copytree(os.path.join(wd, "Result"),
                        os.path.join(wd_cpu, "Result"))
        t_cpu, _, v_cpu = deform_run(torch.device("cpu"), wd_cpu)
        gap = np.abs(v - v_cpu)
        log(f"body deform on the CPU: deform_s {t_cpu['deform_s']:.4f} s; "
            f"card vs CPU max abs {gap.max():.3g}, mean {gap.mean():.3g} "
            f"(bound {DEFORM_GAP_MAX})")
        assert gap.max() <= DEFORM_GAP_MAX, "body deform: card vs CPU"

        kernels.reset_launch_counts()
        t = {}
        rc = main(["render", "--config", config, "--workdir", wd,
                   "--device", str(dev)], stage=synced_timer(t))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        assert rc == 0, f"cli render --config returned {rc}"
        assert launches["raster"] == 2, launches
        raws = [os.path.join(root, f"seq{k}", "DATA", "Render",
                             f"_depth{i}.raw")
                for k in range(2) for i in range(BODY_FRAMES)]
        for r in raws:
            assert os.path.getsize(r) == BODY_W * BODY_H * 4, r
        log(f"body render --config: render_s {t['render_s']:.4f} s "
            f"(synced), {len(raws)} rasters, launches {launches}")

        ident = Similarity.identity(device="cpu")
        meas = [s.disparity for s in seqs]
        cams = [s.cams for s in seqs]
        for name, (mv, mf) in (("template (deform.obj)", (v, tf)),
                               ("scan mesh (control)", (sv, sf))):
            m = {}
            render_stage(torch.as_tensor(mv, device=dev),
                         torch.as_tensor(mf.astype(np.int64), device=dev),
                         [T, ident], cams, measured_disparity=meas,
                         metrics=m)
            log(f"body render of the {name}: coverage "
                f"{m['render_coverage']:.4f}, measured overlap "
                f"{m['measured_overlap']:.4f}")
        assert m["measured_overlap"] > 0.9, m
    phase_config3_loop(dev)
    return arap_prob


def config3_scene(dev):
    """render_bench's config-3 shape: the 224x224 bumpless sphere of radius
    0.8 at z 2.5 and 8 VGA cameras on a 90-degree ring looking at it.
    Returns (vertices, faces, cameras) on ``dev``."""
    from multiviewstitch_tpu_torch.pipeline.fixtures import (ring_cameras,
                                                             uv_sphere)
    v, f = uv_sphere(224, 224, radius=0.8)
    v[:, 2] += 2.5
    cams = ring_cameras(8, radius=2.5, width=W, img_height=H,
                        length_focal=520.0, arc_deg=90.0,
                        look_at=(0.0, 0.0, 2.5), device=dev)
    return (torch.as_tensor(v, device=dev),
            torch.as_tensor(f.astype(np.int64), device=dev), cams)


def phase_config3_loop(dev):
    """bench/render_bench.py's config-3 loop: one outer iteration renders
    the 99,904-face sphere into 8 VGA frames and refines 8 measured maps
    (100 CG iterations) through render_stage(..., refine=True); held
    against the plain render of the same inputs refined on the CPU."""
    from multiviewstitch_tpu_torch.core.transforms import Similarity
    from multiviewstitch_tpu_torch.ops.depth_refine import refine_depth
    from multiviewstitch_tpu_torch.pipeline.deform_render import render_stage
    vt, ft, cams = config3_scene(dev)
    meas = torch.as_tensor(np.random.default_rng(0).uniform(
        0.3, 0.5, size=(8, H, W)).astype(np.float32), device=dev)
    ident = Similarity.identity(device="cpu")

    def outer():
        return render_stage(vt, ft, [ident], [cams],
                            measured_disparity=[meas], refine=True)[0]
    outer()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ts = []
    for _ in range(LOOP_ITERS):
        t0 = time.perf_counter()
        out = outer()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()["raster"]
    assert launches == LOOP_ITERS, launches
    assert torch.isfinite(out).all() and (out > 0).all()
    uvz, fi, ok = tr.project_vertices(
        vt, ft, torch.ones(len(ft), dtype=torch.bool, device=dev), cams)
    plain = tr.raster_reference(uvz, fi, ok, height=H, width=W)
    ms_ref = time_ms(lambda: refine_depth(meas, plain), reps=5)
    got = out.cpu()
    want = refine_depth(meas.cpu(), plain.cpu())
    err = float((got - want).abs().max() / (want.max() - want.min()))
    log(f"config-3 loop (8 x {W}x{H}, {len(ft)} faces, refine 100 CG "
        f"iterations): {1e3 * statistics.median(ts):.3f} ms per outer "
        f"iteration (median of {LOOP_ITERS}, synced; all "
        + ", ".join(f"{1e3 * x:.3f}" for x in ts) +
        f"), refine_depth alone {ms_ref:.3f} ms (CUDA events), K3 launches "
        f"{launches / LOOP_ITERS:.0f} per iteration; the card's outer "
        f"iteration vs the plain render refined on the CPU {err:.3g} of the "
        f"range")
    assert err <= 1e-4, f"config-3 loop, card vs CPU: {err}"


# phase 9: the BA shape named in multiviewstitch_tpu/solvers/ba.py:20-21
BA_CAMS, BA_POINTS, BA_ITERS, BA_CPU_ITERS = 64, 16384, 20, 5
BA_STATE_GAP_MAX = 1e-3


def synth_ba(dev, n_cams=BA_CAMS, n_pts=BA_POINTS, seed=0):
    """bench/solvers.py's synth_ba (dense: every camera sees every point),
    built with the port's rodrigues: cameras on an arc, 0.5 px noise, a
    perturbed start. Cameras 0 and n_cams-1 are fixed at their true poses,
    so the scale is no free direction and two devices' states compare. Returns (problem,
    start state) on ``dev``."""
    from multiviewstitch_tpu_torch.solvers import ba
    rng = np.random.default_rng(seed)
    K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1]],
                 np.float32)
    pts = rng.uniform(-0.8, 0.8, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    rvec = np.stack([[0.0, (i - n_cams / 2) * 0.04, 0.0]
                     for i in range(n_cams)]).astype(np.float32)
    tvec = np.stack([[0.1 * i, 0.0, 0.0]
                     for i in range(n_cams)]).astype(np.float32)
    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    R = ba.rodrigues(torch.as_tensor(rvec)).numpy()
    pc = np.einsum("cij,pj->cpi", R, pts) + tvec[:, None]
    uv_all = np.stack([K[0, 0] * pc[..., 0] / pc[..., 2] + K[0, 2],
                       K[1, 1] * pc[..., 1] / pc[..., 2] + K[1, 2]], -1)
    uv = uv_all[cam_idx, pt_idx] + rng.normal(
        size=(len(cam_idx), 2)).astype(np.float32) * 0.5
    prob = ba.make_problem(K, cam_idx, pt_idx, uv, n_pts,
                           max_obs_per_point=n_cams, n_cams=n_cams,
                           fixed_cams=[0, n_cams - 1], device=dev)
    start = [a + rng.normal(size=a.shape).astype(np.float32) * m
             for a, m in ((rvec, 0.01), (tvec, 0.03), (pts, 0.02))]
    for a, true in zip(start[:2], (rvec, tvec)):     # the fixed cameras
        a[[0, -1]] = true[[0, -1]]
    return prob, ba.BAState(*(torch.as_tensor(a, device=dev) for a in start))


def phase_ba(dev):
    """solve_ba at 64 cameras x 16,384 points on the card: ms per LM
    iteration, peak memory, device-busy share; the card against the CPU
    after BA_CPU_ITERS iterations. Returns the median ms per iteration."""
    from torch.profiler import ProfilerActivity, profile
    from multiviewstitch_tpu_torch.solvers import ba
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob, st0 = synth_ba(dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_obs = int(prob.mask.sum())

    def lm(st, iters, events=None):
        best = ba.reprojection_rmse(prob, st)
        lam = torch.full((), 1e-3, device=dev)
        for _ in range(iters):
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            st, best, lam = ba.lm_step(prob, st, best, lam)
        if events is not None:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        return st, best

    st5, _ = lm(st0, BA_CPU_ITERS)                # also the warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = []
    st, best = lm(st0, BA_ITERS, ev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]
    rmse0 = float(ba.reprojection_rmse(prob, st0))
    rmse = float(best)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm(st0, BA_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n_ev = device_busy_us(prof)

    cpu = torch.device("cpu")
    prob_c, st0_c = synth_ba(cpu)
    t0 = time.perf_counter()
    st5_c, _ = ba.solve_ba(prob_c, st0_c, iters=BA_CPU_ITERS)
    t_cpu = time.perf_counter() - t0
    gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(st5, st5_c))
    log(f"BA {BA_CAMS} cameras x {BA_POINTS} points, {n_obs} observations "
        f"(problem built in {t_build:.3f} s): RMSE {rmse0:.4f} -> {rmse:.4f} "
        f"px in {BA_ITERS} LM iterations; {statistics.median(ms):.3f} ms per "
        f"LM iteration (CUDA events, median; all " +
        ", ".join(f"{x:.2f}" for x in ms) + f"); peak device memory "
        f"{peak:.3f} GB; profiled {BA_ITERS} iterations: wall {wall:.4f} s, "
        f"device busy {busy / 1e6:.4f} s ({100 * busy / 1e6 / wall:.1f} %), "
        f"{n_ev} device events")
    log("    top device events: " + top_device_events(prof))
    log(f"BA card vs CPU after {BA_CPU_ITERS} iterations: max abs state "
        f"difference {gap:.3g} (bound {BA_STATE_GAP_MAX}); CPU "
        f"{t_cpu:.3f} s for {BA_CPU_ITERS} iterations")
    assert rmse < 1.0, f"BA: final RMSE {rmse} px"
    assert gap <= BA_STATE_GAP_MAX, f"BA card vs CPU: {gap}"
    return statistics.median(ms)


# phase 10: the multi-device layer at NCCL world size 1 (one card)
C5_FRAMES, C5_ARC_DEG = 32, 120.0
C5_CFG = CFG.replace(iter_num=64)             # config-2's knobs
C5_LIMITS = (0.08, 4.0)          # tests/test_view_windows.py:116-119
REFINE_GAP_MAX = 1e-3
ARAP_GAP_MAX = 5e-3              # tests/test_parallel.py:133-134


def config5_transform():
    """tests/test_view_windows.py's config-5 similarity: s 1.15, 10 degrees
    about +y, t (0.1, -0.05, 0.15)."""
    from multiviewstitch_tpu_torch.core.transforms import Similarity
    c, s = 0.9848, 0.1736
    return Similarity(torch.tensor(1.15), torch.tensor(
        [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]),
        torch.tensor([0.1, -0.05, 0.15]))


def config5_sequences(dev):
    """Two sequences of 32 VGA frames on a 120-degree arc, the second moved
    by config5_transform (bench/scaling.py:266-276 at the card's width)."""
    from multiviewstitch_tpu_torch.pipeline.align_seq import Sequence
    from multiviewstitch_tpu_torch.pipeline.fixtures import (make_scene,
                                                             textured_views)
    kw = dict(n_frames=C5_FRAMES, width=W, height=H, bumps=0.15, n_lat=48,
              n_lon=64, arc_deg=C5_ARC_DEG, device=dev)
    scenes = [make_scene(**kw),
              make_scene(transform=config5_transform(), **kw)]
    return [Sequence(textured_views(sc), sc.disparity, sc.cams)
            for sc in scenes]


def same_result(a, b):
    """Whether two AlignResults hold identical transforms and keyframes."""
    return a.keyframes == b.keyframes and all(
        torch.equal(x, y) for Ta, Tb in zip(a.transforms, b.transforms)
        for x, y in ((Ta.s, Tb.s), (Ta.R, Tb.R), (Ta.t, Tb.t)))


def max_transform_gap(a, b):
    return max(float((x - y).abs().max())
               for Ta, Tb in zip(a.transforms, b.transforms)
               for x, y in ((Ta.s, Tb.s), (Ta.R, Tb.R), (Ta.t, Tb.t)))


def phase_windowed(dev, mesh):
    """10b: the windowed filter on phase 3's 64-frame VGA sequence at halo
    1 and 2, bit-identical to check_consistency at +-1..+-halo, K1 launched
    through the windowed path."""
    from multiviewstitch_tpu_torch.ops import consistency as tc
    from multiviewstitch_tpu_torch.parallel.view_windows import (
        check_consistency_windowed)
    from multiviewstitch_tpu_torch.pipeline.fixtures import make_scene
    sc = make_scene(n_frames=64, width=W, height=H, bumps=0.15, n_lat=64,
                    n_lon=96, arc_deg=45.0, device=dev)
    d, cams = sc.disparity, sc.cams
    for halo in (1, 2):
        offs = tuple(o for o in range(-halo, halo + 1) if o)
        kernels.reset_launch_counts()
        got = check_consistency_windowed(d, cams, mesh=mesh, halo=halo,
                                         **K1_KW)
        torch.cuda.synchronize()
        n_k1 = kernels.launch_counts()["consistency"]
        want = tc.check_consistency(d, cams, offsets=offs, **K1_KW)
        plain = tc.check_consistency_reference(d, cams, offsets=offs, **K1_KW)
        assert n_k1 == 1, f"windowed filter, halo {halo}: K1 launched {n_k1}"
        assert torch.equal(got, want) and torch.equal(got, plain), \
            f"windowed filter, halo {halo}: {int((got != plain).sum())} differ"
        ms = time_ms(lambda: check_consistency_windowed(
            d, cams, mesh=mesh, halo=halo, **K1_KW))
        log(f"parallel windowed filter, 64x{H}x{W}, halo {halo}: "
            f"bit-identical to check_consistency(offsets={offs}) and its "
            f"plain version, K1 launched once, kept {int((got > 0).sum())} "
            f"of {int((d > 0).sum())}; {ms:.4f} ms (CUDA events, median of "
            f"20, halo exchange + K1)")
    del d, cams, sc
    torch.cuda.empty_cache()


def phase_config5(dev, mesh):
    """10c, 10g: config-5 at full width through align_sequences(mesh=)
    against the unsharded run, then the fuse; per-stage synced times, the
    device-busy share, the peak memory; utils.profiling on the sweep."""
    from multiviewstitch_tpu_torch.core.transforms import rotation_angle_deg
    from multiviewstitch_tpu_torch.parallel.match_dist import (
        match_edges_sharded)
    from multiviewstitch_tpu_torch.pipeline.align_seq import (
        align_sequences, fuse_sequences, pair_key)
    from multiviewstitch_tpu_torch.pipeline.match_edges import (edge_knobs,
                                                                prep_sequence)
    from multiviewstitch_tpu_torch.utils import profiling
    gt = config5_transform()
    ref = align_sequences(config5_sequences(dev), C5_CFG)    # also warm-up
    t = {}
    timed = synced_timer(t)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    seqs = timed("render_s", lambda: config5_sequences(dev))
    preps = timed("prep_s", lambda: [prep_sequence(s, C5_CFG) for s in seqs])
    res = align_sequences(seqs, C5_CFG, preps=preps, mesh=mesh, stage=timed)
    pts, nrm = timed("fuse_s", lambda: fuse_sequences(seqs, res, C5_CFG))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    T = res.transforms[0]
    s_err = abs(float(T.s) - float(gt.s)) / float(gt.s)
    ang = rotation_angle_deg(T.R, gt.R)
    n_edges = C5_FRAMES * C5_FRAMES
    log(f"parallel config-5 (2 x {C5_FRAMES} frames at {W}x{H}, "
        f"{n_edges} edges, max_keypoints {C5_CFG.max_keypoints}, iter_num "
        f"{C5_CFG.iter_num}; NCCL world size {mesh.size}): s {float(T.s):.5f} "
        f"(gt 1.15, error {s_err:.5f}), rotation error {ang:.4f} deg, "
        f"keyframes {res.keyframes}, residual {res.residuals[0]:.5f}; "
        f"identical to the unsharded run: {same_result(res, ref)}; fused "
        f"{len(pts)} points; launches {launches}; peak device memory "
        f"{peak:.3f} GB")
    log("parallel config-5 stage wall times (synced): " + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items()))
    assert same_result(res, ref), "config-5: sharded != unsharded"
    assert s_err < C5_LIMITS[0] and ang < C5_LIMITS[1], (s_err, ang)
    for k in SLICE_KERNELS:
        assert launches[k] > 0, f"config-5: {k} was not launched"
    assert len(pts) > 2000 and np.isfinite(pts).all() and \
        np.isfinite(nrm).all()

    key, knobs = pair_key(0, 0, 1, 2), edge_knobs(C5_CFG)
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir) as prof:
            t0 = time.perf_counter()
            match_edges_sharded(*preps, key, mesh=mesh, **knobs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(logdir, profiling.TRACE_FILE))
    busy, n_ev = device_busy_us(prof)
    assert size > 0 and busy > 0, (size, busy)
    best = profiling.device_time(
        lambda: match_edges_sharded(*preps, key, mesh=mesh, **knobs), reps=3)
    a = torch.randn(512, 512, device=dev)
    flops = profiling.compiled_flops(torch.matmul, a, a)
    log(f"parallel config-5 sweep (match_edges_sharded, {n_edges} edges) "
        f"under utils.profiling.trace: wall {wall:.4f} s (profiled), device "
        f"busy {busy / 1e6:.4f} s ({100 * busy / 1e6 / wall:.1f} %), {n_ev} "
        f"device events, Chrome trace {size} bytes; device_time best of 3 "
        f"{best:.4f} s; compiled_flops(512^2 matmul) {flops:.0f}")
    log("    top device events: " + top_device_events(prof))
    assert flops == 2 * 512 ** 3, flops


def phase_parallel_ba(dev, mesh, ba_ms):
    """10d, 10e: refine="ba" through the mesh on phase 4's turned arc, and
    solve_ba_sharded at phase 9's shape."""
    from multiviewstitch_tpu_torch.parallel import ba_dist
    from multiviewstitch_tpu_torch.pipeline.align_seq import align_sequences
    from multiviewstitch_tpu_torch.solvers import ba
    seqs, gt, _, _ = config2_sequences(dev, ARC_CENTER_DEG)
    ref = align_sequences(seqs, CFG, refine="ba")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = align_sequences(seqs, CFG, refine="ba", mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gap = max_transform_gap(res, ref)
    m = res.metrics
    log(f"parallel refine=ba, turned arc: metrics {m}; transforms vs the "
        f"unsharded refinement max abs {gap:.3g} (bound {REFINE_GAP_MAX}); "
        f"align {wall:.4f} s (synced)")
    check_similarity("parallel refine=ba", res.transforms[0], gt, GT_S)
    assert m["ba_rmse_px"] <= m["ba_rmse_init_px"], m
    assert gap <= REFINE_GAP_MAX, gap

    prob, st0 = synth_ba(dev)
    blocks = ba_dist.BAPointBlocks(prob.K, prob.cam_of, prob.uv_g,
                                   prob.pt_obs_mask, prob.fixed_cams)
    blk = ba_dist.shard_problem(blocks, mesh)

    def lm(iters, events=None):
        st = ba_dist.shard_state(st0, mesh)
        best = ba_dist.rmse_sharded(blk, st, mesh)
        lam = torch.full((), 1e-3, device=dev)
        for _ in range(iters):
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            st, best, lam = ba_dist.lm_step_sharded(blk, st, best, lam, mesh)
        if events is not None:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        return st, best

    st5, _ = lm(BA_CPU_ITERS)                      # also the warm-up
    want, _ = ba.solve_ba(prob, st0, iters=BA_CPU_ITERS)
    ev = []
    _, best = lm(BA_ITERS, ev)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]
    gap = max(float((a - b).abs().max()) for a, b in zip(st5, want))
    log(f"parallel solve_ba_sharded, {BA_CAMS} x {BA_POINTS} on one NCCL "
        f"rank: RMSE {float(best):.4f} px after {BA_ITERS} iterations; "
        f"{statistics.median(ms):.3f} ms per LM iteration (CUDA events, "
        f"median; phase 9's unsharded solve_ba {ba_ms:.3f}); state vs "
        f"solve_ba after {BA_CPU_ITERS} iterations max abs {gap:.3g} "
        f"(bound {BA_STATE_GAP_MAX})")
    assert float(best) < 1.0
    assert gap <= BA_STATE_GAP_MAX, gap


def phase_parallel_arap(dev, mesh, prob):
    """10f: both sharded ARAP layouts on phase 8's body ARAP problem."""
    from multiviewstitch_tpu_torch.parallel import arap_blocks, arap_dist
    from multiviewstitch_tpu_torch.solvers import deformation as D
    want = D.arap_solve(prob)
    e, w = arap_dist.pad_edges(prob.edges.cpu().numpy(),
                               prob.weights.cpu().numpy(), mesh.size)
    padded = prob._replace(edges=torch.as_tensor(e, device=dev),
                           weights=torch.as_tensor(w, device=dev))
    blocks = arap_blocks.build_blocks(
        prob.rest.cpu().numpy(), prob.edges.cpu().numpy(),
        prob.weights.cpu().numpy(), prob.constrained.cpu().numpy(),
        prob.targets.cpu().numpy(), mesh.size)
    for name, fn in (
            ("arap_solve_sharded",
             lambda: arap_dist.arap_solve_sharded(padded, mesh=mesh)),
            ("arap_solve_blocks",
             lambda: arap_blocks.arap_solve_blocks(blocks, mesh=mesh))):
        got = fn()
        gap = float((got - want).abs().max())
        ms = time_ms(fn, reps=5)
        log(f"parallel {name}, body ARAP ({prob.rest.shape[0]} vertices, "
            f"{prob.edges.shape[0]} edges, 5 outer iterations): max abs vs "
            f"arap_solve {gap:.3g} (bound {ARAP_GAP_MAX}); {ms:.3f} ms (CUDA "
            f"events, median of 5)")
        assert gap <= ARAP_GAP_MAX, f"{name}: {gap}"
    log(f"parallel arap_blocks per-rank vertex state "
        f"{arap_blocks.per_device_state_bytes(blocks)} bytes ({mesh.size} "
        f"block)")


def phase_parallel(dev, arap_prob, ba_ms):
    """Phase 10: the multi-device layer on the card at NCCL world size 1
    (one card: NCCL puts one rank on a GPU; the tests hold 2 and 4 ranks
    with gloo on the CPU)."""
    from multiviewstitch_tpu_torch.parallel.mesh import (all_reduce_sum,
                                                         gather_along,
                                                         make_mesh)
    t0 = time.perf_counter()
    mesh = make_mesh()
    try:
        log(f"parallel mesh: backend {mesh.backend}, world size {mesh.size}, "
            f"device {mesh.device}, axis {mesh.shape} (make_mesh in "
            f"{time.perf_counter() - t0:.3f} s)")
        assert (mesh.backend, mesh.size) == ("nccl", 1)
        x = torch.arange(6.0, device=mesh.device)
        flags = x > 2.0
        assert torch.equal(all_reduce_sum(mesh, x.clone()), x)
        assert torch.equal(gather_along(mesh, flags), flags)
        log("parallel mesh: NCCL all_reduce and all_gather (bool as bytes) "
            "return their input at world size 1")
        phase_windowed(dev, mesh)
        phase_config5(dev, mesh)
        phase_parallel_ba(dev, mesh, ba_ms)
        phase_parallel_arap(dev, mesh, arap_prob)
    finally:
        mesh.close()
    log(f"phase 10 (parallel): {time.perf_counter() - t0:.2f} s")


def main():
    name, smi_line = phase_device()
    dev = torch.device("cuda")
    phase_build()
    rec = phase_kernels(dev)
    launches = phase_slice(dev)
    phase_noise_refine(dev)
    phase_cli()
    phase_profile(dev)
    launches["stencil"] = phase_config(dev)
    arap_prob = phase_body(dev)
    ba_ms = phase_ba(dev)
    phase_parallel(dev, arap_prob, ba_ms)
    out = []
    for k in kernels.KERNELS:
        src, replaces = SOURCES[k]
        out.append(dict(name=k, route="cuda", source=src, replaces=replaces,
                        launches=launches[k], **rec[k]))
    print(smi_line, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
