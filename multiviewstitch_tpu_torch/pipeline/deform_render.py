"""Deform and Render stages (the reference's ``-a != 1`` mode).

PyTorch counterpart of ``multiviewstitch_tpu/pipeline/deform_render.py``.

Deform (Processor::Deform, Processor.cpp:1108-1138): the fused scan mesh
and the body template go through rigid alignment (ground removal, PCA
init, part labels, per-limb refit), then the non-rigid ARAP fit; the
result is Result/deform.obj.

Render (Processor::Render, Processor.cpp:1140-1191): the deformed model is
mapped into each sequence's frame by the inverse of its SRT.txt similarity
(p_k = 1/s_k R_k^T (p - t_k)) and drawn into per-frame disparity maps by
``ops/rasterizer.render_sequence`` (K3 on the card; the GLUT Model2Depth
app in the reference), written as DATA/Render/_depth<i>.raw + .jpg.
Optionally the measured depths are refined against the rendered ones
(``ops/depth_refine``).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core.cameras import CameraBatch, _rot3
from ..core.transforms import Similarity, inverse
from ..io.meshio import write_obj
from ..io.rawdepth import save_depth_raw
from ..ops.depth_refine import refine_depth
from ..ops.rasterizer import render_sequence
from ..solvers.alignment import align as rigid_align
from ..solvers.deformation import Deformer, fit_normals
from ..utils.profiling import count, span


class Mesh(NamedTuple):
    """Mode 2's state on one device: a template or scan mesh and, for the
    template, its part labels (models/parts ids)."""
    vertices: torch.Tensor            # [V,3] float32
    faces: torch.Tensor               # [F,3] int64
    labels: Optional[torch.Tensor]    # [V] int32, or None


class DeformStageResult(NamedTuple):
    vertices: torch.Tensor
    faces: torch.Tensor
    normals: torch.Tensor


def _call(name, fn):
    return fn()


def deform_stage(template: Mesh, scan: Mesh, view_ray: np.ndarray,
                 dist_thres: float = 0.7, deform_passes: int = 1,
                 proj_len_err: float = 100.0, proj_dist_err: float = 100.0,
                 out_obj: Optional[str] = None,
                 stage=_call) -> DeformStageResult:
    """Template -> scan fitting (Processor.cpp:1108-1138): normals, the
    correspondence searches and ARAP on the meshes' device. The rigid
    alignment runs as ``stage("deform_align_s", fn)`` and pass k as
    ``stage("deform_pass<k>_s", fn)``.

    The rigid alignment's numeric cores run on the meshes' device and its
    compactions and per-limb loops on the host, as in the JAX package.
    The fit is a discontinuous function of the aligned template (its
    control set and limb anchors are discrete choices), so those choices
    order near-ties by index (solvers/deformation.stable_knn) and the
    device sums run in float64: the card and the CPU pick the same
    controls.

    Spans: ``deform.normals`` (each fit_normals), the rigid alignment's
    (``solvers/alignment.align``) and the Deformer's; counters
    ``deform.scan_vertices``, ``deform.controls``,
    ``deform.arap_iterations`` and ``deform.cg_iterations``."""
    dev = template.vertices.device
    count("deform.scan_vertices", scan.vertices.shape[0])

    def rigid():
        with span("deform.normals"):
            scan_n = fit_normals(scan.vertices, scan.faces)
            tmpl_n = fit_normals(template.vertices, template.faces)
        return rigid_align(
            template.vertices.cpu().numpy(), tmpl_n.cpu().numpy(),
            template.labels.cpu().numpy(), scan.vertices.cpu().numpy(),
            scan_n.cpu().numpy(), scan.faces.cpu().numpy(), view_ray,
            dist_thres, device=dev)
    res = stage("deform_align_s", rigid)

    tgt = torch.as_tensor(res.tgt.astype(np.float32), device=dev)
    with span("deform.normals"):
        if len(res.t_faces):
            tgt_n = fit_normals(tgt, torch.as_tensor(res.t_faces,
                                                     dtype=torch.int64,
                                                     device=dev))
        else:
            tgt_n = torch.as_tensor(res.t_normals, dtype=torch.float32,
                                    device=dev)
    d = Deformer(torch.as_tensor(res.src.astype(np.float32), device=dev),
                 template.faces,
                 torch.as_tensor(res.s_normals, dtype=torch.float32,
                                 device=dev))
    out = d.vertices
    for k in range(deform_passes):
        out = stage(f"deform_pass{k}_s", lambda: d.deform(
            tgt, tgt_n, proj_len_err, proj_dist_err))
    if out_obj:
        write_obj(out_obj, out.cpu().numpy(), d.normals.cpu().numpy(),
                  template.faces.cpu().numpy())
    return DeformStageResult(out, template.faces, d.normals)


# threads that write one sequence's rasters (numpy's file write and PIL's
# JPEG encoder leave the GIL)
RASTER_WRITERS = 8


def depth_images(disparity: torch.Tensor) -> torch.Tensor:
    """``io.rawdepth.depth_to_image`` of every frame of ``disparity``
    [N,H,W] at once on its device: [N,H,W] uint8, each frame's valid
    (non-zero) disparities min-max normalised to 0..255 in float64, the
    same numbers as the host function frame by frame."""
    d = disparity.to(torch.float64)
    valid = d > 0
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=d.device)
    lo = torch.where(valid, d, inf).amin(dim=(1, 2), keepdim=True)
    hi = torch.where(valid, d, -inf).amax(dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 255.0 / (hi - lo), 0.0)
    img = torch.where(valid, (d - lo) * scale, 0.0)
    return img.clamp(0, 255).to(torch.uint8)


def _write_rasters(rdir: str, host: np.ndarray, images: np.ndarray):
    """_depth<i>.raw of each frame of ``host`` [N,H,W] and _depth<i>.jpg of
    its ``images`` [N,H,W] uint8 (``depth_images``) under ``rdir``, frames
    spread over RASTER_WRITERS threads (counter ``io.bytes.render``: the
    bytes written)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image
    os.makedirs(rdir, exist_ok=True)

    def write(i: int) -> int:
        raw = os.path.join(rdir, f"_depth{i}.raw")
        jpg = os.path.join(rdir, f"_depth{i}.jpg")
        save_depth_raw(raw, host[i])
        Image.fromarray(images[i]).save(jpg)
        return os.path.getsize(raw) + os.path.getsize(jpg)

    workers = max(1, min(RASTER_WRITERS, host.shape[0]))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        n_bytes = sum(pool.map(write, range(host.shape[0])))
    count("io.bytes.render", n_bytes)


def render_stage(model_vertices, model_faces,
                 transforms: List[Similarity],
                 sequences_cams: List[CameraBatch],
                 out_dirs: Optional[List[str]] = None,
                 measured_disparity: Optional[list] = None,
                 refine: bool = False,
                 metrics: Optional[dict] = None) -> List[torch.Tensor]:
    """Re-render the model's disparity for every frame of every sequence
    (Processor.cpp:1140-1191 + Model2Depth) on the model's device. Returns
    per-sequence [N,H,W] disparities (refined against
    ``measured_disparity`` with ``refine``); writes
    <out_dirs[k]>/DATA/Render/_depth<i>.raw and .jpg.

    ``metrics`` (a dict) receives the render coverage numbers, the stand-in
    for the reference's visual depth dumps (Common/Utils.h:189-217):
      - render_coverage: fraction of pixels with a rendered surface
      - measured_overlap: fraction of measured-foreground pixels the render
        also covers (with measured_disparity): near zero means the model is
        not where the cameras look (wrong transform or empty render).

    Spans, one a sequence: ``render.raster`` (K3 and the coverage counts,
    the first reads of its raster) and ``render.write``; counters
    ``render.frames``, ``render.faces`` (faces handed to K3, summed over
    the sequences) and ``io.bytes.render``."""
    dev = model_vertices.device
    faces = model_faces.to(device=dev)
    fmask = torch.ones(faces.shape[0], dtype=torch.bool, device=dev)
    outputs = []
    cov_num = cov_den = ovl_num = ovl_den = 0.0
    for k, cams in enumerate(sequences_cams):
        with span("render.raster", sequence=k):
            # the inverse is taken on the host copy, so every device maps
            # the vertices with the same float32 numbers
            inv = inverse(transforms[k].to("cpu")).to(dev)
            pts = _rot3(inv.R, model_vertices) * inv.s + inv.t
            disp = render_sequence(pts, faces, fmask, cams.to(dev),
                                   height=cams.height, width=cams.width)
            cov_num += float((disp > 0).sum())
            cov_den += float(disp.numel())
            if measured_disparity is not None:
                meas = torch.as_tensor(measured_disparity[k], device=dev)
                fg = meas > 0
                ovl_num += float(((disp > 0) & fg).sum())
                ovl_den += float(fg.sum())
            if refine and measured_disparity is not None:
                disp = refine_depth(meas.to(torch.float32), disp)
        count("render.frames", disp.shape[0])
        count("render.faces", faces.shape[0])

        if out_dirs is not None:
            with span("render.write", sequence=k):
                _write_rasters(os.path.join(out_dirs[k], "DATA", "Render"),
                               disp.cpu().numpy(),
                               depth_images(disp).cpu().numpy())
        outputs.append(disp)
    if metrics is not None:
        metrics["render_coverage"] = cov_num / max(cov_den, 1.0)
        if measured_disparity is not None:
            metrics["measured_overlap"] = ovl_num / max(ovl_den, 1.0)
    return outputs
