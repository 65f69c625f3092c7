"""ctypes wrappers of the hand-written CUDA kernels in ``csrc/``.

Each wrapper checks every tensor argument with ``_arg`` (type, dtype,
shape, contiguity, then device, so the CPU tests reach the shape errors)
and then that the call's tensors lie on a card, allocates its outputs
with ``torch.empty``, launches on PyTorch's current stream, raises on the
launcher's ``cudaGetLastError()`` code, and adds one to its launch
counter ``kernels.launch.<kernel>`` (``utils.profiling.count``; once per
call, however many CUDA kernels the call runs). K3 also counts the
(face, tile) pairs it binned, ``kernels.raster_pairs``. The plain
PyTorch version of each kernel lives beside its caller in ``ops/``
(``check_consistency_reference``, ``sample_oriented_points_reference``,
``raster_reference``; K4's are the stencil functions of ``ops/poisson``);
the public ops take it only for tensors on the CPU.

Kernels:
  consistency      K1, csrc/consistency.cu  (ops/consistency.check_consistency)
  oriented_points  K2, csrc/sampling.cu     (ops/point_sampling
                                             .sample_oriented_points)
  raster           K3, csrc/raster.cu       (ops/rasterizer.render_sequence)
  stencil          K4, csrc/stencil.cu      (ops/poisson: the Jacobi sweeps,
                                             the restricted residual, the
                                             prolongation, the coarsest
                                             solve, the CG matvec and the
                                             splat's box blur; six wrappers,
                                             stencil_*, one counter)
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count, counters, reset_counters
from . import _build

KERNELS = ("consistency", "oriented_points", "raster", "stencil")
LAUNCH = "kernels.launch."       # the launch counters' prefix


def launch_counts() -> dict:
    """Launches per kernel since the last reset (a copy)."""
    c = counters(LAUNCH)
    return {k: c.get(LAUNCH + k, 0) for k in KERNELS}


def reset_launch_counts():
    reset_counters(LAUNCH)


def _stream(t: torch.Tensor):
    # PyTorch's current stream on t's device as a raw cudaStream_t (what
    # torch.compile's generated code uses): ~0.3 us a call on an H100 host,
    # against ~7 us for torch.cuda.current_stream(), which builds a Stream
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _arg(t, name: str, dtype, shape, device=None) -> torch.Size:
    """Check the kernel argument ``t``, in this order: a tensor, of
    ``dtype``, of ``shape``, contiguous, on ``device`` (where given: the
    call's first tensor's). A letter in ``shape`` is any size, the same
    wherever it recurs. Returns t.shape."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    sizes = {}
    if t.dim() != len(shape) or any(
            n != (sizes.setdefault(s, n) if isinstance(s, str) else s)
            for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"[{','.join(map(str, shape))}]")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    return t.shape


def _load(kernel: str, t: torch.Tensor):
    """The kernels' library, for a call whose checked tensors lie on t's
    device, which must be a card."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors")
    return _build.load()


def _frames(disparity: torch.Tensor, K, R, t, name: str):
    """(n, h, w) of a disparity stack [N,H,W] and its cameras."""
    n, h, w = _arg(disparity, "disparity", torch.float32, "NHW")
    dev = disparity.device
    _arg(K, "K", torch.float32, (n, 3, 3), dev)
    _arg(R, "R", torch.float32, (n, 3, 3), dev)
    _arg(t, "t", torch.float32, (n, 3), dev)
    if n > 65535 or h * w >= 2 ** 31:
        raise ValueError(f"{name}: {n} frames of {w}x{h} are too many")
    return n, h, w


# csrc/consistency.cu: kMaxOffsets neighbour offsets, each within kMaxHalo
_K1_MAX_OFFSETS = 8
_K1_MAX_HALO = 16


def consistency(disparity: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                t: torch.Tensor, *, min_dsp: float, max_dsp: float,
                reproj_err: float, offsets=(-1, 1)) -> torch.Tensor:
    """K1: [N,H,W] disparity filtered by the round trip into the frames at
    ``offsets`` (at most 8, each within +-16 frames)."""
    n, h, w = _frames(disparity, K, R, t, "consistency")
    offs = [int(o) for o in offsets]
    if not (1 <= len(offs) <= _K1_MAX_OFFSETS and
            all(abs(o) <= _K1_MAX_HALO for o in offs)):
        raise ValueError(f"consistency: offsets {tuple(offsets)}: 1 to "
                         f"{_K1_MAX_OFFSETS} of them, each within "
                         f"+-{_K1_MAX_HALO}")
    lib = _load("consistency", disparity)
    out = torch.empty_like(disparity)
    c_offs = (ctypes.c_int * len(offs))(*offs)
    err = lib.mvs_consistency(
        disparity.data_ptr(), K.data_ptr(), R.data_ptr(), t.data_ptr(),
        out.data_ptr(), n, h, w, c_offs, len(offs), float(min_dsp),
        float(max_dsp), float(reproj_err) * float(reproj_err),
        _stream(disparity))
    _build.check(lib, err, "consistency")
    count(LAUNCH + "consistency")
    return out


def oriented_points(disparity: torch.Tensor, K: torch.Tensor,
                    R: torch.Tensor, t: torch.Tensor, centers: torch.Tensor,
                    *, sample_radius: int, nbr_num: int, nbr_step: int,
                    min_dsp: float, max_dsp: float, dsp_err: float,
                    conf_min: float):
    """K2: the oriented point sampler of a disparity stack [N,H,W] whose
    camera centres are ``centers`` [N,3]. Returns (points [N,S,3], normals
    [N,S,3], conf [N,S], valid [N,S] bool), S = Hs * Ws samples a frame at
    stride ``sample_radius``."""
    n, h, w = _frames(disparity, K, R, t, "oriented_points")
    dev = disparity.device
    _arg(centers, "centers", torch.float32, (n, 3), dev)
    r, nbr_num, nbr_step = int(sample_radius), int(nbr_num), int(nbr_step)
    if r < 1 or nbr_num < 0 or nbr_num * abs(nbr_step) >= 2 ** 30:
        raise ValueError(f"oriented_points: sample_radius {r}, nbr_num "
                         f"{nbr_num}, nbr_step {nbr_step}")
    lib = _load("oriented_points", disparity)
    s = -(-h // r) * -(-w // r)
    f32 = dict(dtype=torch.float32, device=dev)
    points = torch.empty((n, s, 3), **f32)
    normals = torch.empty((n, s, 3), **f32)
    conf = torch.empty((n, s), **f32)
    valid = torch.empty((n, s), dtype=torch.bool, device=dev)
    err = lib.mvs_oriented_points(
        disparity.data_ptr(), K.data_ptr(), R.data_ptr(), t.data_ptr(),
        centers.data_ptr(), points.data_ptr(), normals.data_ptr(),
        conf.data_ptr(), valid.data_ptr(), n, h, w, r, nbr_num, nbr_step,
        float(min_dsp), float(max_dsp), float(dsp_err), float(conf_min),
        _stream(disparity))
    _build.check(lib, err, "oriented_points")
    count(LAUNCH + "oriented_points")
    return points, normals, conf, valid


# csrc/raster.cu: 16x16-pixel tiles, work items of 256 face records, a
# 64-byte meta header; the bbox columns and rows are packed into 16 bits
_RASTER_TILE = 16
_RASTER_ITEM = 256
_RASTER_MAX_SIDE = 16384
_RASTER_MAX_BINS = 1 << 26     # the bins allocated before the host read
PAIRS = "kernels.raster_pairs"  # (face, tile) pairs K3 binned, summed


def _raster_launch(lib, uvz, faces, face_ok, zbuf, n_bins, cap, stream):
    """Allocate K3's scratch for ``cap`` (face, tile) pairs and launch it;
    returns the scratch, whose first 16 bytes are the pair total and the
    error word once the kernels have run."""
    n, v = uvz.shape[:2]
    nf = faces.shape[0]
    h, w = zbuf.shape[1:]
    item_cap = n_bins + cap // _RASTER_ITEM + 1
    # meta + counts (zeroed by the launcher), offsets, items, records, bins
    items_at = 64 + 8 * n_bins
    rec_at = -(-(items_at + 8 * item_cap) // 256) * 256
    bins_at = rec_at + 48 * n * nf
    scratch = torch.empty(bins_at + 4 * cap, dtype=torch.uint8,
                          device=uvz.device)
    base = scratch.data_ptr()
    err = lib.mvs_raster(uvz.data_ptr(), faces.data_ptr(),
                         face_ok.data_ptr(), base + rec_at, base,
                         base + 64 + 4 * n_bins, base + items_at, item_cap,
                         base + bins_at, cap, zbuf.data_ptr(), n, v, nf, h, w,
                         stream)
    _build.check(lib, err, "raster")
    return scratch


def raster(uvz: torch.Tensor, faces: torch.Tensor, face_ok: torch.Tensor,
           *, height: int, width: int) -> torch.Tensor:
    """K3: z-max disparity [N,height,width] of faces [F,3] over per-frame
    projected vertices uvz [N,V,3] (u, v, 1/z); face_ok [N,F] bool.

    Two memsets and four CUDA kernels (setup + tile counts, scan, scatter
    into tile bins, per-tile fine pass), then one device-to-host read: the
    (face, tile) pair total and the error word of the vertex-id range
    check. The bins are allocated beforehand for 2 pairs a face and 2
    faces a tile; if the total does not fit, the last two kernels write
    nothing and the call runs again with room for every pair. The total
    is added to the counter ``kernels.raster_pairs``."""
    n, v, _ = _arg(uvz, "uvz", torch.float32, ("N", "V", 3))
    dev = uvz.device
    nf = _arg(faces, "faces", torch.int32, ("F", 3), dev)[0]
    _arg(face_ok, "face_ok", torch.bool, (n, nf), dev)
    h, w = int(height), int(width)
    if not (0 <= h <= _RASTER_MAX_SIDE and 0 <= w <= _RASTER_MAX_SIDE):
        raise ValueError(f"raster: {w}x{h} image, at most "
                         f"{_RASTER_MAX_SIDE} pixels a side")
    lib = _load("raster", uvz)
    if n == 0 or h == 0 or w == 0:          # nothing to render
        count(PAIRS, 0)
        return torch.zeros((n, h, w), dtype=torch.float32, device=dev)
    n_bins = n * -(-h // _RASTER_TILE) * -(-w // _RASTER_TILE)
    if n > 65535 or n_bins >= 2 ** 30:
        raise ValueError(f"raster: {n} frames of {w}x{h} are too many")
    zbuf = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    stream = _stream(uvz)
    cap = min(2 * n * nf + 2 * n_bins, _RASTER_MAX_BINS)
    scratch = _raster_launch(lib, uvz, faces, face_ok, zbuf, n_bins, cap,
                             stream)
    total, bad = scratch[:16].view(torch.int64).tolist()   # the one host read
    if bad:
        raise ValueError("faces: vertex index out of range")
    if total > cap:                 # the bins were too small: run again
        if total >= 2 ** 31:
            raise ValueError(f"raster: {total} (face, tile) pairs overflow "
                             "the int32 bin index")
        _raster_launch(lib, uvz, faces, face_ok, zbuf, n_bins, total, stream)
    count(PAIRS, total)
    count(LAUNCH + "raster")
    return zbuf


# csrc/stencil.cu: the one-block solve holds at most 16^3 cells; launch
# grids cap a side at 65535
STENCIL_COARSEST_CELLS = 4096
_STENCIL_MAX_SIDE = 65535
_SWEEP_JACOBI, _SWEEP_MATVEC, _SWEEP_RESTRICT = 0, 1, 2


def _f32(v: float) -> float:
    """v rounded to float32 (to nearest), as PyTorch casts a Python scalar
    for a float32 tensor."""
    return ctypes.c_float(v).value


def _jacobi_coef(screen: float, omega: float):
    """(-screen, omega, 1 / diag) in float32, as the plain version's ops
    use them on the card: add_'s alpha and mul_'s factor cast to float,
    and div_ by the Python scalar -6 - screen run as a product with its
    float reciprocal (exact after the double quotient: 53 >= 2 * 24 + 2
    bits)."""
    return (_f32(-screen), _f32(omega), _f32(1.0 / _f32(-6.0 - screen)))


def _stencil_launch(fn, fields, g: int, *scalars):
    """Launch K4's ``fn`` on ``fields`` (in the launcher's order; None is
    a null pointer), their side ``g`` and ``scalars``. The fields must lie
    on a card and no two may share memory: each kernel reads and writes
    distinct fields."""
    given = [f for f in fields if f is not None]
    lib = _load("stencil", given[0])
    if len({f.data_ptr() for f in given}) != len(given):
        raise ValueError("stencil: the fields must not share memory")
    if not 1 <= g <= _STENCIL_MAX_SIDE:
        raise ValueError(f"stencil: side {g}, expected 1 to "
                         f"{_STENCIL_MAX_SIDE}")
    err = getattr(lib, fn)(*(None if f is None else f.data_ptr()
                             for f in fields), g, *scalars,
                           _stream(given[0]))
    _build.check(lib, err, "stencil")
    count(LAUNCH + "stencil")


def stencil_jacobi(x: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *,
                   screen: float, omega: float) -> torch.Tensor:
    """K4: one damped-Jacobi sweep of (L - screen) x = b (the unscaled
    periodic 7-point stencil L, diagonal -6 - screen) from x [G,G,G] into
    ``out``; returns ``out``."""
    cube = _arg(x, "x", torch.float32, "GGG")
    _arg(b, "b", torch.float32, cube, x.device)
    _arg(out, "out", torch.float32, cube, x.device)
    _stencil_launch("mvs_stencil_sweep", (x, b, out), cube[0], _SWEEP_JACOBI,
                    *_jacobi_coef(screen, omega))
    return out


def stencil_matvec(x: torch.Tensor, *, screen: float) -> torch.Tensor:
    """K4: (L - screen) x of x [G,G,G], a new field."""
    g = _arg(x, "x", torch.float32, "GGG")[0]
    out = torch.empty_like(x)
    _stencil_launch("mvs_stencil_sweep", (x, None, out), g, _SWEEP_MATVEC,
                    *_jacobi_coef(screen, 1.0))
    return out


def stencil_residual_restrict(x: torch.Tensor, b: torch.Tensor, *,
                              screen: float) -> torch.Tensor:
    """K4: 4 * restrict2(b - (L - screen) x) of x, b [G,G,G] (G even): the
    coarse right-hand side [G/2]^3 of a V-cycle, without the fine
    residual."""
    cube = _arg(x, "x", torch.float32, "GGG")
    _arg(b, "b", torch.float32, cube, x.device)
    g = cube[0]
    if g % 2:
        raise ValueError(f"stencil_residual_restrict: side {g} is odd, "
                         "the 2x2x2 blocks need an even side")
    out = torch.empty((g // 2,) * 3, dtype=x.dtype, device=x.device)
    _stencil_launch("mvs_stencil_sweep", (x, b, out), g, _SWEEP_RESTRICT,
                    *_jacobi_coef(screen, 1.0))
    return out


def stencil_prolong_add(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """K4: x [G,G,G] += e [G/2]^3 broadcast over 2x2x2 blocks (G even), in
    place; returns x."""
    g = _arg(x, "x", torch.float32, "GGG")[0]
    if g % 2:
        raise ValueError(f"stencil_prolong_add: side {g} is odd, the 2x2x2 "
                         "blocks need an even side")
    _arg(e, "e", torch.float32, (g // 2,) * 3, x.device)
    _stencil_launch("mvs_stencil_prolong", (x, e), g)
    return x


def stencil_coarsest(x: torch.Tensor, b: torch.Tensor, *, screen: float,
                     omega: float, iters: int) -> torch.Tensor:
    """K4: ``iters`` damped-Jacobi sweeps of x [G,G,G] in place, in one
    launch of one block (G^3 <= STENCIL_COARSEST_CELLS); returns x."""
    cube = _arg(x, "x", torch.float32, "GGG")
    _arg(b, "b", torch.float32, cube, x.device)
    g = cube[0]
    if g ** 3 > STENCIL_COARSEST_CELLS or int(iters) < 0:
        raise ValueError(f"stencil_coarsest: {g}^3 cells, {iters} sweeps "
                         f"(at most {STENCIL_COARSEST_CELLS} cells)")
    _stencil_launch("mvs_stencil_coarsest", (x, b), g, int(iters),
                    *_jacobi_coef(screen, omega))
    return x


def stencil_box_blur(a: torch.Tensor, out: torch.Tensor, *,
                     axis: int) -> torch.Tensor:
    """K4: one periodic 3-tap box pass of a [G,G,G] along ``axis`` (0 z,
    1 y, 2 x), ((a + a[i-1]) + a[i+1]) / 3, into ``out``; returns out."""
    cube = _arg(a, "a", torch.float32, "GGG")
    _arg(out, "out", torch.float32, cube, a.device)
    if axis not in (0, 1, 2):
        raise ValueError(f"stencil_box_blur: axis {axis}, expected 0, 1 or 2")
    _stencil_launch("mvs_stencil_blur", (a, out), cube[0], axis,
                    _f32(1.0 / 3.0))
    return out
