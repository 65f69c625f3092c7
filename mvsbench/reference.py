"""The plain reference the correctness check holds a job's outputs to.

It imports nothing of the port. What it computes again from the
benchmark's own inputs (the scene it generated, the cameras it wrote):

  - ``fuse``: the fused oriented cloud (PSR.npts) of the port's
    ``align_seq.fuse_sequences`` semantics: the cross-view consistency
    filter against the frames at -1 and +1, the strided oriented-point
    sampler with its neighbour-frame agreement vote, the visibility filter
    and the map into the last sequence's frame. It maps through the
    job's SRT.txt: the similarities are the job's estimate, checked
    against the truth on their own (``judge.py``).
  - ``render``: the job's re-render of deform.obj into every frame (the
    port's ``render --config``), drawn again by ``raster.py``.

Every camera product is a matrix product (``geometry.Mat``); with
``precision="tf32"`` their operands are rounded to TF32, the control that
has to fail the check. Alongside: readers of the output files, the exact
point-to-triangle distance to a mesh, and the mesh's connected
components.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .geometry import Cams, Mat, Sim, pixel_grid
from .raster import render as raster_render


# -- output files -------------------------------------------------------------

def _numbers(text: bytes, dtype) -> np.ndarray:
    """Whitespace-separated numbers of ``text`` (numpy's C parser)."""
    return np.fromstring(text, dtype=dtype, sep=" ")


def read_obj(path: str):
    """(vertices [V,3] float32, faces [F,3] int64, 0-based) of an OBJ with
    ``v``, ``vn`` and ``f a b c`` / ``f a//a ...`` / ``f a/b/c`` lines."""
    with open(path, "rb") as f:
        data = f.read()
    if b"vn " in data or b"/" in data:
        lines = data.splitlines()
        v = b" ".join(ln[2:] for ln in lines if ln.startswith(b"v "))
        fl = b" ".join(ln[2:] for ln in lines if ln.startswith(b"f "))
        fl = b" ".join(t.split(b"/", 1)[0] for t in fl.split())
    else:           # the writer's plain form: every v line, then every f
        cut = data.find(b"\nf ")
        cut = len(data) if cut < 0 else cut + 1
        v = data[:cut].replace(b"v ", b" ")
        fl = data[cut:].replace(b"f ", b" ")
    verts = _numbers(v, np.float32).reshape(-1, 3)
    faces = _numbers(fl, np.int64)
    faces = np.where(faces > 0, faces - 1, len(verts) + faces)
    return verts, faces.reshape(-1, 3)


def read_npts(path: str):
    """(points [P,3], normals [P,3]) float32 of ``x y z nx ny nz`` lines."""
    with open(path, "rb") as f:
        a = _numbers(f.read(), np.float32).reshape(-1, 6)
    return a[:, :3], a[:, 3:]


def read_srt(path: str) -> List[Sim]:
    """One similarity per block of 13 numbers (s, R row-major, t)."""
    with open(path) as f:
        vals = np.array(f.read().split(), np.float64)
    return [Sim(float(vals[i]), vals[i + 1:i + 10].reshape(3, 3),
                vals[i + 10:i + 13]) for i in range(0, len(vals) - 12, 13)]


def read_raw(path: str, width: int, height: int) -> np.ndarray:
    a = np.fromfile(path, np.float32)
    if a.size != width * height:
        raise ValueError(f"{path}: {a.size} floats, expected "
                         f"{width * height}")
    return a.reshape(height, width)


# -- the fused cloud ----------------------------------------------------------

def _gather(img, v, u):
    """img [N,H,W] at integer pixels (v, u) [N,...] (clipped)."""
    n, h, w = img.shape
    flat = (v.clamp(0, h - 1) * w + u.clamp(0, w - 1)).long().reshape(n, -1)
    return torch.gather(img.reshape(n, -1), 1, flat).reshape(v.shape)


def _round(x):
    return torch.floor(x + 0.5)


def _cams_at(cams: Cams, idx, extra: int):
    """(K, R, t) of frames ``idx`` with ``extra`` broadcast dims."""
    K, R, t = cams.K[idx], cams.R[idx], cams.t[idx]
    for _ in range(extra):
        K, R, t = K[:, None], R[:, None], t[:, None]
    return K, R, t


def consistency(disp, cams: Cams, mat: Mat, *, min_dsp, max_dsp,
                reproj_err, offsets=(-1, 1)):
    """Disparity [N,H,W] with the pixels that fail the round trip into an
    existing neighbour frame (or are out of range) set to 0."""
    n, h, w = disp.shape
    dev = disp.device
    valid = (disp >= min_dsp) & (disp <= max_dsp)
    uv = pixel_grid(h, w, device=dev)[None].expand(n, h, w, 2)
    depth = 1.0 / torch.where(valid, disp, torch.ones_like(disp))
    own = _cams_at(cams, torch.arange(n, device=dev), 2)
    pts = mat.unproject(*own, uv, depth)
    keep = valid
    for off in offsets:
        ar = torch.arange(n, device=dev)
        nbr = (ar + off).clamp(0, n - 1)
        exists = ((ar + off >= 0) & (ar + off < n))[:, None, None]
        ncam = _cams_at(cams, nbr, 2)
        uvn, zn = mat.project(*ncam, pts)
        un, vn = _round(uvn[..., 0]), _round(uvn[..., 1])
        inb1 = (un >= 0) & (un <= w - 1) & (vn >= 0) & (vn <= h - 1) & \
            (zn > 0)
        uc, vc = un.clamp(0, w - 1), vn.clamp(0, h - 1)
        dn = _gather(disp[nbr], vc, uc)
        ref_valid = (dn >= min_dsp) & (dn <= max_dsp)
        back = mat.unproject(*ncam, torch.stack([uc, vc], -1), 1.0 /
                             torch.where(ref_valid, dn, torch.ones_like(dn)))
        uvb, _ = mat.project(*own, back)
        ub, vb = _round(uvb[..., 0]), _round(uvb[..., 1])
        inb2 = (ub >= 0) & (ub <= w - 1) & (vb >= 0) & (vb <= h - 1)
        du, dv = uv[..., 0] - ub, uv[..., 1] - vb
        ok = inb1 & ref_valid & inb2 & \
            (du * du + dv * dv <= float(reproj_err) ** 2)
        keep = keep & torch.where(exists, ok, torch.ones_like(ok))
    return torch.where(keep, disp, torch.zeros_like(disp))


def oriented_samples(disp, cams: Cams, mat: Mat, *, min_dsp, max_dsp,
                     sample_radius, nbr_num, nbr_step, dsp_err, conf_min):
    """(points [N,S,3], normals [N,S,3], keep [N,S]) of every
    ``sample_radius``-strided pixel: the normal of the cross product of
    the wrapped central differences, turned to face the camera; kept where
    valid, with a normal, and agreed on by at least ``conf_min`` of the
    existing frames at +-k*nbr_step (k = 1..nbr_num)."""
    n, h, w = disp.shape
    dev = disp.device
    r = sample_radius
    valid = (disp >= min_dsp) & (disp <= max_dsp)
    depth = 1.0 / torch.where(valid, disp, torch.ones_like(disp))
    uv = pixel_grid(h, w, device=dev)[None].expand(n, h, w, 2)
    ar = torch.arange(n, device=dev)
    pts = mat.unproject(*_cams_at(cams, ar, 2), uv, depth)

    def shift(a, dy, dx):
        return torch.roll(a, shifts=(-dy, -dx), dims=(1, 2))[:, ::r, ::r]

    ps = pts[:, ::r, ::r]
    zero = torch.zeros((), dtype=pts.dtype, device=dev)
    du = torch.where((shift(valid, 0, 1) & shift(valid, 0, -1))[..., None],
                     shift(pts, 0, 1) - shift(pts, 0, -1), zero)
    dv = torch.where((shift(valid, 1, 0) & shift(valid, -1, 0))[..., None],
                     shift(pts, 1, 0) - shift(pts, -1, 0), zero)
    nrm = torch.cross(dv, du, dim=-1)
    nlen = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / nlen.clamp_min(1e-12)
    centers = -mat.mv(cams.R.transpose(-1, -2), cams.t)[:, None, None]
    nrm = torch.where((((centers - ps) * nrm).sum(-1) < 0)[..., None], -nrm,
                      nrm)

    votes = torch.zeros(ps.shape[:3], device=dev)
    total = torch.zeros_like(votes)
    for k in range(1, nbr_num + 1):
        for sgn in (-1, 1):
            off = sgn * k * nbr_step
            nbr = (ar + off).clamp(0, n - 1)
            exists = ((ar + off >= 0) & (ar + off < n)).float()[:, None,
                                                                  None]
            uvn, zn = mat.project(*_cams_at(cams, nbr, 2), ps)
            un, vn = _round(uvn[..., 0]), _round(uvn[..., 1])
            inb = (un >= 0) & (un <= w - 1) & (vn >= 0) & (vn <= h - 1) & \
                (zn > 0)
            dn = _gather(disp[nbr], vn, un)
            dproj = torch.where(zn > 1e-12, 1.0 / zn.clamp_min(1e-12),
                                torch.zeros_like(zn))
            agree = inb & ((dn - dproj).abs() <= dsp_err) & \
                (dn >= min_dsp) & (dn <= max_dsp)
            votes = votes + exists * agree.float()
            total = total + exists
    conf = torch.where(total > 0, votes / total.clamp_min(1.0),
                       torch.ones_like(votes))
    keep = valid[:, ::r, ::r] & (nlen[..., 0] > 1e-12) & (conf >= conf_min)
    return ps.reshape(n, -1, 3), nrm.reshape(n, -1, 3), keep.reshape(n, -1)


def visible(points, cams: Cams, mat: Mat):
    """[S] points [S,3] that project inside every camera, in front of it."""
    ar = torch.arange(len(cams), device=points.device)
    uv, z = mat.project(*_cams_at(cams, ar, 1), points[None])
    return ((uv[..., 0] >= 0) & (uv[..., 0] <= cams.width - 1) &
            (uv[..., 1] >= 0) & (uv[..., 1] <= cams.height - 1) &
            (z > 0)).all(0)


def fuse(sequences, srt: List[Sim], cfg: dict, mat: Mat):
    """The fused cloud (points, normals) as numpy float32, in the order
    PSR.npts lists it. ``sequences``: [(disparity [N,H,W], Cams)];
    ``cfg``: min_dsp, max_dsp, reproj_err, sample_radius, nbr_frm_num,
    nbr_frm_step, dsp_err, conf_min."""
    out_p, out_n = [], []
    for (disp, cams), T in zip(sequences, srt):
        d = consistency(disp, cams, mat, min_dsp=cfg["min_dsp"],
                        max_dsp=cfg["max_dsp"],
                        reproj_err=cfg["reproj_err"])
        p, nrm, keep = oriented_samples(
            d, cams, mat, min_dsp=cfg["min_dsp"], max_dsp=cfg["max_dsp"],
            sample_radius=cfg["sample_radius"], nbr_num=cfg["nbr_frm_num"],
            nbr_step=cfg["nbr_frm_step"], dsp_err=cfg["dsp_err"],
            conf_min=cfg["conf_min"])
        p, nrm = p.reshape(-1, 3), nrm.reshape(-1, 3)
        keep = keep.reshape(-1) & visible(p, cams, mat)
        R = torch.as_tensor(T.R, dtype=torch.float32, device=p.device)
        t = torch.as_tensor(T.t, dtype=torch.float32, device=p.device)
        out_p.append((T.s * mat.mv(R, p) + t)[keep])
        out_n.append(mat.mv(R, nrm)[keep])
    return (torch.cat(out_p).cpu().numpy(), torch.cat(out_n).cpu().numpy())


# -- the re-render ------------------------------------------------------------

def render(vertices: np.ndarray, faces: np.ndarray, srt: List[Sim],
           cams_list: List[Cams], mat: Mat):
    """Per sequence [N,H,W] disparity of the mesh mapped into sequence k
    by the inverse of its similarity."""
    out = []
    for cams, T in zip(cams_list, srt):
        inv = T.inverse()
        v = torch.as_tensor(inv.apply(vertices.astype(np.float64)),
                            dtype=torch.float32, device=cams.K.device)
        out.append(raster_render(v, torch.as_tensor(faces,
                                                    device=cams.K.device),
                                 cams, mat))
    return out


# -- surfaces -----------------------------------------------------------------

def _closest_on_triangles(p, a, b, c):
    """Closest points on triangles (a, b, c) [...,3] to p [...,3] (the
    Voronoi-region walk of Ericson, Real-Time Collision Detection 5.1.5)."""
    def dot(x, y):
        return (x * y).sum(-1)
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = dot(ab, ap), dot(ac, ap)
    bp = p - b
    d3, d4 = dot(ab, bp), dot(ac, bp)
    cp = p - c
    d5, d6 = dot(ab, cp), dot(ac, cp)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    den = va + vb + vc
    den = torch.where(den.abs() > 0, den, torch.ones_like(den))
    out = a + ab * (vb / den)[..., None] + ac * (vc / den)[..., None]

    def sel(cond, q):
        return torch.where(cond[..., None], q, out)

    def ratio(x, y):
        return x / torch.where(y.abs() > 0, y, torch.ones_like(y))
    e43, e56 = d4 - d3, d5 - d6
    out = sel((va <= 0) & (e43 >= 0) & (e56 >= 0),
              b + (c - b) * ratio(e43, e43 + e56)[..., None])
    out = sel((vb <= 0) & (d2 >= 0) & (d6 <= 0),
              a + ac * ratio(d2, d2 - d6)[..., None])
    out = sel((d6 >= 0) & (d5 <= d6), c)
    out = sel((vc <= 0) & (d1 >= 0) & (d3 <= 0),
              a + ab * ratio(d1, d1 - d3)[..., None])
    out = sel((d3 >= 0) & (d4 <= d3), b)
    return sel((d1 <= 0) & (d2 <= 0), a)


def surface_distance(points: np.ndarray, verts: np.ndarray,
                     faces: np.ndarray, device, k: int = 16,
                     chunk: int = 1 << 15) -> np.ndarray:
    """Distance [P] from each point to the mesh (verts, faces): exact, in
    float64, to the nearest of the ``k`` faces whose centroids lie
    nearest, on ``device``."""
    if len(points) == 0:
        return np.zeros(0)
    tri = torch.as_tensor(verts.astype(np.float64)[faces], device=device)
    cen = tri.mean(1).float()
    k = min(k, len(faces))
    out = []
    for s in range(0, len(points), chunk):
        p = torch.as_tensor(points[s:s + chunk], dtype=torch.float64,
                            device=device)
        idx = torch.cdist(p.float(), cen).topk(k, largest=False).indices
        t = tri[idx]
        q = _closest_on_triangles(p[:, None], t[..., 0, :], t[..., 1, :],
                                  t[..., 2, :])
        out.append(torch.linalg.norm(q - p[:, None], dim=-1).min(1)
                   .values.cpu())
    return torch.cat(out).numpy()


def components(n_verts: int, faces: np.ndarray) -> int:
    """Edge-connected components of a mesh, each unreferenced vertex one."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    g = coo_matrix((np.ones(len(e), np.int8), (e[:, 0], e[:, 1])),
                   shape=(n_verts, n_verts))
    return int(connected_components(g, directed=False)[0])


def nearest(a: np.ndarray, b: np.ndarray):
    """(distance, index) of each point of ``a`` to its nearest in ``b``."""
    from scipy.spatial import cKDTree
    if len(b) == 0:
        return np.full(len(a), np.inf), np.zeros(len(a), np.int64)
    return cKDTree(b.astype(np.float64)).query(a.astype(np.float64), k=1,
                                               workers=-1)
