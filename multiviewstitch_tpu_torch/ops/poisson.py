"""Screened Poisson surface reconstruction on a regular grid.

PyTorch counterpart of ``multiviewstitch_tpu/ops/poisson.py``. The
reference's Poisson stage is the closed-source GeoRec binary (RunPoisson,
Reconstruction/GeometryRec.cpp:61-86) with octree depth knobs
``psn_dpt_min..max`` (config.txt:33-34). This is the regular-grid
equivalent at resolution 2^depth: splat the oriented points into a normal
field, solve the screened Poisson equation for the indicator function, and
extract the iso-surface whose level is the mean indicator value at the
samples (Kazhdan's iso selection) with the surface-nets extractor shared
with the TSDF backend.

Two solvers: Jacobi-preconditioned CG (below grid 256) and geometric
multigrid V-cycles (damped-Jacobi smoothing, 2x2x2 mean restriction,
piecewise-constant prolongation; the stencil is unscaled, so the
restricted residual and the screen coefficient scale by 4 per level).

The JAX package's TPU shapes are not kept: restriction is three pairwise
means (the JAX package's 0/0.5 pairing-matrix einsums compute the same
values, at ~2 TFLOP per restriction at 1024^3), prolongation is one
in-place broadcast add, and every periodic stencil (``roll`` in the JAX
package) adds shifted slices in place, so no stencil materialises a
rolled copy. At 1024^3 one field is 4.29 GB; the solve holds three (the
right-hand side, the solution and one scratch field) plus the coarse
levels. Nothing in the solvers reads a value back to the host.

On CUDA tensors the stencils run on K4, the hand-written kernels of
``csrc/stencil.cu`` (``kernels.stencil_*``), bit-identical to the plain
code here, which serves CPU tensors (``_on_k4``): each Jacobi sweep of
``_smooth_jacobi`` is one pass (x and b read once, x' written into a
scratch field, the two swapped), every sweep of a grid of at most 16^3
cells one launch of one block, ``_vcycle``'s coarse right-hand side
``_restrict2(_residual(...)) * 4`` one pass that never writes the fine
residual, ``_prolong_add`` one pass, each axis step of ``_box_blur_`` one
pass, and ``_matvec`` (``_cg``) one pass. The splat, the divergence, the
iso gather, the dilation and the extraction stay plain PyTorch.

Above grid 256 the surface is extracted in overlapping Z-slabs (each face
owned by exactly one slab; duplicated halo vertices are welded on the host
by integer cell key). Unlike the JAX package, the extraction has no vertex
or face capacity, so no mesh is truncated. The three steps run as the
spans ``poisson.field``, ``poisson.dilate`` and ``poisson.extract``
(``utils.profiling``); inside the extraction each slab (its surface nets
and the copy to the host) is a ``poisson.slab`` span and the host weld a
``poisson.weld`` span. Counters: ``poisson.vcycles``, ``poisson.slabs``,
``poisson.slab_vertices`` (into the weld) and ``poisson.vertices`` (the
extracted mesh's).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import kernels
from ..utils.profiling import count, span
from .tsdf import TSDF, surface_nets


def _corners(pts_idx, G: int):
    """(flat index [N], trilinear weight [N]) of each of the 8 corners of
    continuous grid coords [N,3] (x,y,z), in the JAX package's order."""
    base = torch.floor(pts_idx)
    frac = pts_idx - base
    base = base.to(torch.int64)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[:, 0] if dx else 1 - frac[:, 0]) *
                     (frac[:, 1] if dy else 1 - frac[:, 1]) *
                     (frac[:, 2] if dz else 1 - frac[:, 2]))
                ix = (base[:, 0] + dx).clamp(0, G - 1)
                iy = (base[:, 1] + dy).clamp(0, G - 1)
                iz = (base[:, 2] + dz).clamp(0, G - 1)
                yield (iz * G + iy) * G + ix, w


def _trilinear_scatter(G: int, pts_idx, values):
    """Scatter-add values [N] into a [G,G,G] (z,y,x) grid with trilinear
    weights; one accumulating index_put_ over all 8 corners (atomic, so
    unordered, on the card)."""
    idx, val = zip(*((i, w * values) for i, w in _corners(pts_idx, G)))
    out = torch.zeros(G ** 3, dtype=values.dtype, device=values.device)
    out.index_put_((torch.cat(idx),), torch.cat(val), accumulate=True)
    return out.view(G, G, G)


def _trilinear_gather(field, pts_idx):
    """Sample field [G,G,G] at continuous grid coords [N,3] (x,y,z)."""
    flat = field.reshape(-1)
    acc = 0.0
    for i, w in _corners(pts_idx, field.shape[0]):
        acc = acc + w * flat[i]
    return acc


def _acc_roll(out, x, shift: int, dim: int, alpha: float = 1.0):
    """out += alpha * torch.roll(x, shift, dim) for shift +-1 (out |= for
    bool), from two shifted slices: no rolled copy of x."""
    n = x.shape[dim]
    parts = (((1, 0, n - 1), (0, n - 1, 1)) if shift == 1 else
             ((0, 1, n - 1), (n - 1, 0, 1)))
    for dst, src, k in parts:
        o = out.narrow(dim, dst, k)
        if out.dtype == torch.bool:
            o |= x.narrow(dim, src, k)
        else:
            o.add_(x.narrow(dim, src, k), alpha=alpha)
    return out


def _on_k4(t) -> bool:
    """Whether the stencils of t run on K4 (``kernels.stencil_*``): CUDA
    tensors do, CPU tensors take the plain code."""
    return t.device.type == "cuda"


def _box_blur_(x):
    """Two rounds of the per-axis 3-tap periodic box filter (the splat's
    mild B-spline-like smoothing), in place on x with one scratch field:
    the six passes alternate between the two buffers and end in x."""
    a, tmp = x, torch.empty_like(x)
    for _ in range(2):
        for ax in range(3):
            if _on_k4(a):
                kernels.stencil_box_blur(a, tmp, axis=ax)
            else:
                tmp.copy_(a)
                _acc_roll(tmp, a, 1, ax)
                _acc_roll(tmp, a, -1, ax)
                tmp.div_(3.0)
            a, tmp = tmp, a
    return a


def _laplacian(x):
    """Unscaled periodic 7-point stencil."""
    out = x * -6.0
    for ax in range(3):
        _acc_roll(out, x, 1, ax)
        _acc_roll(out, x, -1, ax)
    return out


def _matvec(x, screen: float):
    """(L - screen) x."""
    if _on_k4(x):
        return kernels.stencil_matvec(x, screen=screen)
    return _laplacian(x).add_(x, alpha=-screen)


def _residual(x, b, screen: float):
    """b - (L - screen) x, as a new field."""
    return _matvec(x, screen).neg_().add_(b)


def _smooth_jacobi(x, b, screen: float, iters: int, omega: float = 0.8):
    """Damped Jacobi relaxation of (L - screen) x = b in place (diagonal
    -6 - screen). On K4: every sweep of a grid of at most 16^3 cells in
    one launch, else one launch a sweep into a scratch field, swapped
    with x (x holds the result at the end)."""
    if _on_k4(x):
        if x.numel() <= kernels.STENCIL_COARSEST_CELLS:
            return kernels.stencil_coarsest(x, b, screen=screen, omega=omega,
                                            iters=iters)
        src, dst = x, torch.empty_like(x)
        for _ in range(iters):
            src, dst = kernels.stencil_jacobi(src, b, dst, screen=screen,
                                              omega=omega), src
        return x if src is x else x.copy_(src)
    for _ in range(iters):
        x.add_(_residual(x, b, screen).mul_(omega).div_(-6.0 - screen))
    return x


def _restrict2(x):
    """Full-weighting restriction: the 2x2x2 mean, as pairwise means along
    z, then y, then x (the JAX package's einsum order and rounding)."""
    for d in range(3):
        x = x.unflatten(d, (x.shape[d] // 2, 2))
        x = (x.select(d + 1, 0) + x.select(d + 1, 1)).mul_(0.5)
    return x


def _prolong_add(x, e):
    """x += piecewise-constant prolongation of the coarse field e, in
    place."""
    if _on_k4(x):
        return kernels.stencil_prolong_add(x, e)
    g0, g1, g2 = e.shape
    x.view(g0, 2, g1, 2, g2, 2).add_(e[:, None, :, None, :, None])
    return x


def _vcycle(x, b, screen: float, *, coarsest: int = 16, nu: int = 2):
    """One multigrid V-cycle on the unscaled screened-Laplacian stencil, in
    place on x: nu pre-smoothing sweeps, the coarse correction, nu
    post-smoothing sweeps; nu + 40 sweeps at the coarsest level. Residual
    and screen scale by 4 per level (h^2 of the continuous operator under
    the unscaled stencil)."""
    if x.shape[0] <= coarsest:
        return _smooth_jacobi(x, b, screen, nu + 40)
    _smooth_jacobi(x, b, screen, nu)
    if _on_k4(x):
        bc = kernels.stencil_residual_restrict(x, b, screen=screen)
    else:
        bc = _restrict2(_residual(x, b, screen)).mul_(4.0)
    ec = _vcycle(torch.zeros_like(bc), bc, 4.0 * screen, coarsest=coarsest,
                 nu=nu)
    del bc
    _prolong_add(x, ec)
    del ec
    return _smooth_jacobi(x, b, screen, nu)


def _multigrid(b, screen: float, vcycles: int):
    """``vcycles`` V-cycles of (L - screen) x = b from x = 0."""
    x = torch.zeros_like(b)
    for _ in range(vcycles):
        _vcycle(x, b, screen)
    count("poisson.vcycles", vcycles)
    return x


def _cg(b, screen: float, iters: int):
    """Jacobi-preconditioned CG from x = 0; the scalars stay on the
    device (no host read per iteration)."""
    diag = -6.0 - screen
    x = torch.zeros_like(b)
    r = b - _matvec(x, screen)
    z = r / diag
    p = z
    rz = torch.vdot(r.reshape(-1), z.reshape(-1))
    for _ in range(iters):
        Ap = _matvec(p, screen)
        pAp = torch.vdot(p.reshape(-1), Ap.reshape(-1))
        alpha = rz / pAp.abs().clamp_min(1e-20) * torch.sign(pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r / diag
        rz2 = torch.vdot(r.reshape(-1), z.reshape(-1))
        beta = rz2 / torch.where(rz.abs() < 1e-20,
                                 torch.full_like(rz, 1e-20), rz)
        p = z + beta * p
        rz = rz2
    return x


def poisson_field(points, normals, valid, origin, spacing, *,
                  grid: int = 128, cg_iters: int = 300, screen: float = 1e-3,
                  solver: str = "auto", vcycles: int = 12):
    """Solve (L - screen) chi = div V for the indicator-like field chi on
    the points' device and return (chi - iso, point_weight_grid), so the
    zero level set is the surface.

    solver: "cg", "multigrid", or "auto" (multigrid from grid >= 256)."""
    gidx = (points - origin) / spacing                    # (x,y,z) coords
    w = valid.to(points.dtype)
    # the divergence rhs one normal component at a time (no [G^3,3] V):
    # div(smooth(splat(n))) == sum_ax d_ax(smooth(splat(n_ax)))
    b = torch.zeros((grid,) * 3, dtype=points.dtype, device=points.device)
    for comp_ax, grid_ax in ((0, 2), (1, 1), (2, 0)):   # (x,y,z) storage
        comp = _box_blur_(_trilinear_scatter(grid, gidx,
                                             normals[:, comp_ax] * w))
        d = torch.roll(comp, -1, grid_ax)
        _acc_roll(d, comp, 1, grid_ax, alpha=-1.0)
        del comp
        b.add_(d.mul_(0.5))
        del d
    if solver == "auto":
        solver = "multigrid" if grid >= 256 else "cg"
    if solver == "multigrid":
        x = _multigrid(b, screen, vcycles)
    else:
        x = _cg(b, screen, cg_iters)
    del b

    # iso level: mean field value at the input samples
    iso = ((_trilinear_gather(x, gidx) * w).sum() /
           w.sum().clamp_min(1.0))
    # sample-weight grid scattered after the solve (not held across it)
    wgt = _box_blur_(_trilinear_scatter(grid, gidx, w))
    return x.sub_(iso), wgt


def _dilate_occupancy(wgt, radius: int):
    """Bool occupancy (wgt > eps) dilated by ``radius`` voxels (periodic,
    like the JAX package's rolls)."""
    occ = wgt > 1e-6
    for _ in range(radius):
        for ax in range(3):
            out = occ.clone()
            _acc_roll(out, occ, 1, ax)
            _acc_roll(out, occ, -1, ax)
            occ = out
    return occ


def _extract_mesh(field, occ, origin, spacing):
    """surface_nets, copied to the host. Sign flip: chi > iso
    inside (normals outward); surface nets expects negative inside like a
    TSDF. Returns numpy (verts, faces, cells) — cells are the per-vertex
    integer (z,y,x) owning grid cells (exact identity for cross-slab
    welds)."""
    tsdf_like = TSDF(-field, occ.to(field.dtype), origin, float(spacing))
    mesh = surface_nets(tsdf_like, min_weight=0.5)
    return (mesh.vertices.cpu().numpy(),
            mesh.faces.cpu().numpy().astype(np.int32),
            mesh.cells.cpu().numpy().astype(np.int32))


def _extract_mesh_slabs(field, occ, origin, spacing, slab: int = 64,
                        return_cells: bool = False):
    """Z-slab extraction: overlapping slabs of ``slab`` interior cell
    layers (+1 halo cell layer each side so boundary faces see all four of
    their cells), welded on the host by GLOBAL INTEGER CELL keys —
    surface nets emits exactly one vertex per cell, so (z+slab_offset, y,
    x) is an exact identity. Faces are owned by the slab containing their
    minimum global cell z, so each face is emitted exactly once."""
    G = field.shape[0]
    n_cells = G - 1
    origin_np = origin.cpu().numpy()
    all_v, all_f, all_c = [], [], []
    for z0 in range(0, n_cells, slab):
        z1 = min(z0 + slab, n_cells)
        lo = max(z0 - 1, 0)
        hi = min(z1 + 1, n_cells) + 1                # +1: corner layer
        sub_origin = np.asarray(origin_np, np.float32).copy()
        sub_origin[2] += lo * float(spacing)         # z offset (x,y,z)
        count("poisson.slabs")
        with span("poisson.slab", z0=z0):
            v, f, c = _extract_mesh(field[lo:hi], occ[lo:hi],
                                    torch.as_tensor(sub_origin,
                                                    device=field.device),
                                    spacing)
            if len(f) == 0:
                continue
            c = c.astype(np.int64)
            c[:, 0] += lo                            # global cell z
            # own faces whose min global cell z lies in [z0, z1)
            fz = c[f][:, :, 0].min(1)
            keep = (fz >= z0) & (fz < z1) if z1 < n_cells else (fz >= z0)
            f = f[keep]
            base = sum(len(x) for x in all_v)
            all_v.append(v)
            all_c.append(c)
            all_f.append(f + base)
    if not all_v:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    with span("poisson.weld"):
        V = np.concatenate(all_v)
        C = np.concatenate(all_c)
        F = np.concatenate(all_f)
        # weld halo duplicates by exact global cell key
        uniq, inv = np.unique(C, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        first = np.zeros(len(uniq), np.int64)
        first[inv[::-1]] = np.arange(len(V))[::-1]   # first occurrence
        Vw = V[first]
        Fw = inv[F]
        good = (Fw[:, 0] != Fw[:, 1]) & (Fw[:, 1] != Fw[:, 2]) & \
            (Fw[:, 0] != Fw[:, 2])
    count("poisson.slab_vertices", len(V))
    count("poisson.vertices", len(Vw))
    if return_cells:
        return Vw.astype(np.float32), Fw[good], C[first]
    return Vw.astype(np.float32), Fw[good]


def reconstruct_poisson(points: np.ndarray, normals: np.ndarray, *,
                        depth: int = 7, margin: float = 0.1,
                        cg_iters: int = 300, support_radius: int = 6,
                        solver: str = "auto", vcycles: int = 12,
                        device) -> Tuple[np.ndarray, np.ndarray]:
    """Full Poisson pipeline on ``device``: oriented numpy cloud ->
    numpy (vertices, faces). ``depth`` mirrors psn_dpt: grid = 2^depth
    (the reference runs 8-10, config.txt:33-34). Extraction is restricted
    to cells within ``support_radius`` voxels of any sample (far-field chi
    is unconstrained, like the octree's adaptive support). Grids from 256
    use the multigrid solver; above 256 the extraction runs in Z-slabs."""
    grid = 1 << depth
    mins = points.min(0)
    maxs = points.max(0)
    extent = (maxs - mins).max()
    mins = mins - margin * extent
    spacing = float((maxs - mins + margin * extent).max() / (grid - 1))
    f32 = dict(dtype=torch.float32, device=device)
    origin = torch.as_tensor(mins, **f32)

    pts = torch.as_tensor(points, **f32)
    with span("poisson.field"):
        field, wgt = poisson_field(
            pts, torch.as_tensor(normals, **f32),
            torch.ones(len(points), dtype=torch.bool, device=device), origin,
            spacing, grid=grid, cg_iters=cg_iters, solver=solver,
            vcycles=vcycles)
    with span("poisson.dilate"):
        occ = _dilate_occupancy(wgt, support_radius)
    del wgt

    with span("poisson.extract"):
        if grid <= 256:
            v, f, _ = _extract_mesh(field, occ, origin, spacing)
            count("poisson.vertices", len(v))
            return v, f
        # thinner slabs past 512: the per-slab work arrays scale with
        # slab * G^2 and sit next to the field
        return _extract_mesh_slabs(field, occ, origin, spacing,
                                   slab=64 if grid <= 512 else 32)
