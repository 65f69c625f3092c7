"""ctypes wrappers of the hand-written CUDA kernels in ``csrc/``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises
on the launcher's ``cudaGetLastError()`` code, and adds one to its launch
counter ``kernels.launch.<kernel>`` (``utils.profiling.count``; once per
call, however many CUDA kernels the call runs). The plain
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
raster_pairs = None   # (face, tile) pairs K3 binned in its last call


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


def _require(t: torch.Tensor, name: str, dtype, shape, device):
    # one test on the common path; the specific message only on failure
    if (isinstance(t, torch.Tensor) and t.device == device and
            t.dtype == dtype and t.shape == shape and t.is_contiguous()):
        return
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    raise ValueError(f"{name}: must be contiguous")


def _frames(disparity: torch.Tensor, K, R, t, name: str):
    """(n, h, w) of a CUDA disparity stack [N,H,W] and its cameras."""
    if disparity.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors")
    if disparity.dim() != 3:
        raise ValueError(f"disparity: shape {tuple(disparity.shape)}, "
                         "expected [N,H,W]")
    n, h, w = disparity.shape
    dev = disparity.device
    _require(disparity, "disparity", torch.float32, (n, h, w), dev)
    _require(K, "K", torch.float32, (n, 3, 3), dev)
    _require(R, "R", torch.float32, (n, 3, 3), dev)
    _require(t, "t", torch.float32, (n, 3), dev)
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
    out = torch.empty_like(disparity)
    lib = _build.load()
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
    _require(centers, "centers", torch.float32, (n, 3), dev)
    r, nbr_num, nbr_step = int(sample_radius), int(nbr_num), int(nbr_step)
    if r < 1 or nbr_num < 0 or nbr_num * abs(nbr_step) >= 2 ** 30:
        raise ValueError(f"oriented_points: sample_radius {r}, nbr_num "
                         f"{nbr_num}, nbr_step {nbr_step}")
    s = -(-h // r) * -(-w // r)
    f32 = dict(dtype=torch.float32, device=dev)
    points = torch.empty((n, s, 3), **f32)
    normals = torch.empty((n, s, 3), **f32)
    conf = torch.empty((n, s), **f32)
    valid = torch.empty((n, s), dtype=torch.bool, device=dev)
    lib = _build.load()
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
    nothing and the call runs again with room for every pair. The total is
    kept in ``raster_pairs``."""
    global raster_pairs
    if uvz.device.type != "cuda":
        raise ValueError("raster kernel needs CUDA tensors")
    dev = uvz.device
    if uvz.dim() != 3 or uvz.shape[2] != 3:
        raise ValueError(f"uvz: shape {tuple(uvz.shape)}, expected [N,V,3]")
    n, v = uvz.shape[:2]
    nf = faces.shape[0]
    _require(uvz, "uvz", torch.float32, (n, v, 3), dev)
    _require(faces, "faces", torch.int32, (nf, 3), dev)
    _require(face_ok, "face_ok", torch.bool, (n, nf), dev)
    h, w = int(height), int(width)
    if not (0 <= h <= _RASTER_MAX_SIDE and 0 <= w <= _RASTER_MAX_SIDE):
        raise ValueError(f"raster: {w}x{h} image, at most "
                         f"{_RASTER_MAX_SIDE} pixels a side")
    if n == 0 or h == 0 or w == 0:          # nothing to render
        raster_pairs = 0
        return torch.zeros((n, h, w), dtype=torch.float32, device=dev)
    n_bins = n * -(-h // _RASTER_TILE) * -(-w // _RASTER_TILE)
    if n > 65535 or n_bins >= 2 ** 30:
        raise ValueError(f"raster: {n} frames of {w}x{h} are too many")
    zbuf = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    lib = _build.load()
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
    raster_pairs = total
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


def _cube(t, name: str, side=None) -> int:
    """Side G of the float32 contiguous cube t [G,G,G] (of side ``side``
    if given). Needs no card, so it runs before the device check."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    g = t.shape[0] if t.dim() == 3 else 0
    if (tuple(t.shape) != (g, g, g) or not 1 <= g <= _STENCIL_MAX_SIDE or
            side is not None and g != side):
        want = "[G,G,G]" if side is None else f"[{side},{side},{side}]"
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return g


def _even(g: int, what: str):
    if g % 2:
        raise ValueError(f"{what}: side {g} is odd, the 2x2x2 blocks need "
                         "an even side")


def _card(*named):
    """Raise unless every (name, tensor) lies on one CUDA device and no
    two share memory (each kernel reads and writes distinct fields)."""
    dev = named[0][1].device
    if dev.type != "cuda":
        raise ValueError("stencil kernel needs CUDA tensors")
    for name, t in named[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
    ptrs = [t.data_ptr() for _, t in named]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("stencil: the fields must not share memory")


def _stencil_launch(fn, *args):
    lib = _build.load()
    err = getattr(lib, fn)(*args)
    _build.check(lib, err, "stencil")
    count(LAUNCH + "stencil")


def stencil_jacobi(x: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *,
                   screen: float, omega: float) -> torch.Tensor:
    """K4: one damped-Jacobi sweep of (L - screen) x = b (the unscaled
    periodic 7-point stencil L, diagonal -6 - screen) from x [G,G,G] into
    ``out``; returns ``out``."""
    g = _cube(x, "x")
    _cube(b, "b", g)
    _cube(out, "out", g)
    _card(("x", x), ("b", b), ("out", out))
    _stencil_launch("mvs_stencil_sweep", x.data_ptr(), b.data_ptr(),
                    out.data_ptr(), g, _SWEEP_JACOBI,
                    *_jacobi_coef(screen, omega), _stream(x))
    return out


def stencil_matvec(x: torch.Tensor, *, screen: float) -> torch.Tensor:
    """K4: (L - screen) x of x [G,G,G], a new field."""
    g = _cube(x, "x")
    _card(("x", x))
    out = torch.empty_like(x)
    _stencil_launch("mvs_stencil_sweep", x.data_ptr(), None, out.data_ptr(),
                    g, _SWEEP_MATVEC, *_jacobi_coef(screen, 1.0), _stream(x))
    return out


def stencil_residual_restrict(x: torch.Tensor, b: torch.Tensor, *,
                              screen: float) -> torch.Tensor:
    """K4: 4 * restrict2(b - (L - screen) x) of x, b [G,G,G] (G even): the
    coarse right-hand side [G/2]^3 of a V-cycle, without the fine
    residual."""
    g = _cube(x, "x")
    _cube(b, "b", g)
    _even(g, "stencil_residual_restrict")
    _card(("x", x), ("b", b))
    out = torch.empty((g // 2,) * 3, dtype=x.dtype, device=x.device)
    _stencil_launch("mvs_stencil_sweep", x.data_ptr(), b.data_ptr(),
                    out.data_ptr(), g, _SWEEP_RESTRICT,
                    *_jacobi_coef(screen, 1.0), _stream(x))
    return out


def stencil_prolong_add(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """K4: x [G,G,G] += e [G/2]^3 broadcast over 2x2x2 blocks (G even), in
    place; returns x."""
    g = _cube(x, "x")
    _even(g, "stencil_prolong_add")
    _cube(e, "e", g // 2)
    _card(("x", x), ("e", e))
    _stencil_launch("mvs_stencil_prolong", x.data_ptr(), e.data_ptr(), g,
                    _stream(x))
    return x


def stencil_coarsest(x: torch.Tensor, b: torch.Tensor, *, screen: float,
                     omega: float, iters: int) -> torch.Tensor:
    """K4: ``iters`` damped-Jacobi sweeps of x [G,G,G] in place, in one
    launch of one block (G^3 <= STENCIL_COARSEST_CELLS); returns x."""
    g = _cube(x, "x")
    _cube(b, "b", g)
    if g ** 3 > STENCIL_COARSEST_CELLS or int(iters) < 0:
        raise ValueError(f"stencil_coarsest: {g}^3 cells, {iters} sweeps "
                         f"(at most {STENCIL_COARSEST_CELLS} cells)")
    _card(("x", x), ("b", b))
    _stencil_launch("mvs_stencil_coarsest", x.data_ptr(), b.data_ptr(), g,
                    int(iters), *_jacobi_coef(screen, omega), _stream(x))
    return x


def stencil_box_blur(a: torch.Tensor, out: torch.Tensor, *,
                     axis: int) -> torch.Tensor:
    """K4: one periodic 3-tap box pass of a [G,G,G] along ``axis`` (0 z,
    1 y, 2 x), ((a + a[i-1]) + a[i+1]) / 3, into ``out``; returns out."""
    g = _cube(a, "a")
    _cube(out, "out", g)
    if axis not in (0, 1, 2):
        raise ValueError(f"stencil_box_blur: axis {axis}, expected 0, 1 or 2")
    _card(("a", a), ("out", out))
    _stencil_launch("mvs_stencil_blur", a.data_ptr(), out.data_ptr(), g,
                    axis, _f32(1.0 / 3.0), _stream(a))
    return out
