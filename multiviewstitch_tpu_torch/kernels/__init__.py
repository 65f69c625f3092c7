"""ctypes wrappers of the hand-written CUDA kernels in ``csrc/``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises
on the launcher's ``cudaGetLastError()`` code, and adds one to its launch
counter ``kernels.launch.<kernel>`` (``utils.profiling.count``; once per
call, however many CUDA kernels the call runs). The plain
PyTorch version of each kernel lives beside its caller in ``ops/``
(``check_consistency_reference``, ``sample_oriented_points_reference``,
``raster_reference``); the public ops take it only for tensors on the CPU.

Kernels:
  consistency      K1, csrc/consistency.cu  (ops/consistency.check_consistency)
  oriented_points  K2, csrc/sampling.cu     (ops/point_sampling
                                             .sample_oriented_points)
  raster           K3, csrc/raster.cu       (ops/rasterizer.render_sequence)
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count, counters, reset_counters
from . import _build

KERNELS = ("consistency", "oriented_points", "raster")
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
