"""On-card smoke run of the PyTorch port (multiviewstitch_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU, nvcc and this repository's sources; imports no jax.
Phases, in order (any failure raises and the exit code is non-zero):
  1. device: the card's name and power limit (nvidia-smi)
  2. build: one nvcc per csrc/*.cu source, all started together, into
     the git-ignored kernel directory
  3. kernels: K1 (consistency), K2 (the oriented point sampler) and K3
     (raster), each against its plain PyTorch version on the card. K1 and
     K2 at three sizes of the sphere scene (640x480): config-2 (5 frames,
     nbr_num 1), the front-end (8 frames, bench.py's settings, nbr_num 2)
     and a long sequence (64 frames on the 45-degree arc, the reference's
     default settings, nbr_num 5; 78.6 MB of disparity, more than L2); K1
     bit-identical, K2's points bit-identical, conf and the keep mask
     equal on >= 99.99 % of samples, normals within 1e-6 on >= 99.99 % of
     the samples both keep. K3 bit-identical on four cases (the config-2
     sphere, a ~100k-face sphere, two close-up giant faces, and a close-up
     ring of 8 cameras around and inside a 100k-face sphere), with each
     case's largest clipped bbox and (face, tile) pair count (the kernel's
     own total). Each case logs kernel and plain ms (median of 20 timed
     runs, CUDA events), device us per CUDA kernel (torch.profiler) and
     the least time the card could take (bound) with its share
  4. the align slice at config-2 (2 sequences x 5 frames at 640x480,
     max_keypoints 512, TSDF grid 256) through ``cli.run_align``: render,
     prep, edge sweep + solve, fuse, TSDF, trim + write; checks the
     recovered similarity, the fused cloud's RMSE and that every kernel
     launched during the run; then once more with the second sequence's
     camera arc centred half a frame step away, so that no keyframe pair
     shares a pose and RANSAC has to reject outliers
  5. the CLI: ``align --demo --device cuda``
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
     surface, the ten per-frame meshes and that K1 and K2 launched; logs
     per-stage synced wall times, the Poisson stage's peak device memory,
     the grid and the mesh sizes; the depth-10 run's Poisson stage runs
     under torch.profiler (device busy share, and each step's host span
     and device time from the ``poisson.*`` record_function ranges);
     then a warm pass at psn_dpt_max 8 (256^3, whole-grid extraction) and
     the host time of the depth-10 mesh's largest-component trim
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
}
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
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.load()
    log(f"build: {path} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {'ran' if _build.build_seconds else 'cached'})")


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


def k1_bound(d):
    """K1 reads and writes each disparity once (plus the cameras); per valid
    pixel 25 flops (1/d, unprojection) and per existing neighbour 88 (two
    projections of 25, an unprojection of 24 and 1/d, two roundings of 4,
    the error test of 5): csrc/consistency.cu."""
    n, h, w = d.shape
    valid = ((d >= CFG.min_dsp) & (d <= CFG.max_dsp)).flatten(1).sum(1).cpu()
    pairs = int((valid * existing_neighbours(n, (-1, 1))).sum())
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


def phase_kernels(dev):
    """Each kernel against its plain version at the main path's shapes."""
    from multiviewstitch_tpu_torch.pipeline.fixtures import (make_scene,
                                                             uv_sphere,
                                                             ring_cameras)
    from multiviewstitch_tpu_torch.core.cameras import CameraBatch

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
        if name == "config-2":        # the main path's shapes
            rec["consistency"], rec["oriented_points"] = k1, k2
        del d, cams
        torch.cuda.empty_cache()

    def raster_case(name, verts, faces, rcams, h, w, main=False):
        uvz, fi, ok = tr.project_vertices(
            torch.as_tensor(verts, device=dev),
            torch.as_tensor(faces, device=dev),
            torch.ones(len(faces), dtype=torch.bool, device=dev), rcams)
        got = tr.raster(uvz, fi, ok, height=h, width=w)
        pairs = kernels.raster_pairs
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
    torch.cuda.synchronize()
    return rec


def rmse_to(points, verts, dev):
    p = torch.as_tensor(points, device=dev)
    v = torch.as_tensor(verts, device=dev)
    d2 = torch.cat([torch.cdist(c, v).min(1).values ** 2
                    for c in p.split(8192)])
    return float(d2.mean().sqrt())


def synced_timer(t):
    """A ``run_align`` stage hook that stores each stage's synced wall
    seconds in ``t``."""
    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        return out
    return stage


def run_slice(dev, workdir, arc_center_deg=0.0, stage=None):
    """The config-2 align slice through the port's entry points; returns
    (stage seconds, gt, result, points, normals, moved scene, mesh)."""
    t = {}
    stage = stage or synced_timer(t)
    seqs, gt, _, moved = stage("render_s",
                               lambda: config2_sequences(dev,
                                                         arc_center_deg))
    res, pts, nrm, v, f = run_align(seqs, CFG, GRID, workdir, stage)
    t["total_s"] = sum(t.values())
    return t, gt, res, pts, nrm, moved, (v, f)


def check_slice(name, dev, gt, res, pts, nrm, moved, mesh):
    from multiviewstitch_tpu_torch.core.transforms import rotation_angle_deg
    T = res.transforms[0]
    s_err = abs(float(T.s) - GT_S) / GT_S
    ang = rotation_angle_deg(T.R, gt.R)
    t_err = float(np.linalg.norm(T.t.numpy() - gt.t.numpy()))
    rmse = rmse_to(pts, moved.vertices, dev)
    v, f = mesh
    log(f"slice {name}: s {float(T.s):.5f} (gt {GT_S}), rotation error "
        f"{ang:.4f} deg, translation error {t_err:.5f}, keyframes "
        f"{res.keyframes}, residual {res.residuals[0]:.5f}, fused points "
        f"{len(pts)}, fused RMSE {rmse:.5f}, mesh {len(v)} verts / "
        f"{len(f)} faces")
    assert s_err <= 0.05, f"{name}: scale {float(T.s)} vs {GT_S}"
    assert ang < 3.0, f"{name}: rotation error {ang} deg"
    assert t_err < 0.08, f"{name}: translation error {t_err}"
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
    for name in kernels.KERNELS:
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


# record_function ranges of ops/poisson.reconstruct_poisson's steps
POISSON_STEPS = ("poisson.field", "poisson.dilate", "poisson.extract")


def device_events(prof):
    """The device-side events (kernels, memcpys, memsets) of a profile,
    without the device-side copies of the record_function ranges."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in POISSON_STEPS]


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


def log_poisson_profile(prof, wall, depth):
    """Device busy share of a profiled Poisson stage, and each step's host
    span and the device time of the kernels it launched (its
    record_function range)."""
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
    log("    top device events: " + top_device_events(prof))
    assert busy > 0, "the profiler saw no device-side Poisson events"


def phase_config(dev):
    """``align --config`` on the reference's on-disk layout with Poisson
    at the default depth 10, segment, AllSeqProj and per-frame meshes."""
    with tempfile.TemporaryDirectory() as root:
        config, gt, moved = write_config_layout(dev, root)
        wd = os.path.join(root, "work10")
        kernels.reset_launch_counts()
        t, outs, prof = config_run(dev, config, wd, CONFIG_DEPTHS[0],
                                   profile_poisson=True)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        log(f"launches during the config run: {launches}")
        check_config_run("PsnDptMax 10 (Poisson 1024^3; poisson_s "
                         "profiled)", dev, wd, gt, moved, t)
        for k in ("consistency", "oriented_points"):
            assert launches[k] > 0, f"{k} was not launched by align --config"
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


def main():
    name, smi_line = phase_device()
    dev = torch.device("cuda")
    phase_build()
    rec = phase_kernels(dev)
    launches = phase_slice(dev)
    phase_cli()
    phase_profile(dev)
    phase_config(dev)
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
