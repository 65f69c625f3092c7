"""ctypes wrappers of the hand-written CUDA kernels in ``csrc/``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``/``torch.zeros``, launches on PyTorch's current
stream, raises on the launcher's ``cudaGetLastError()`` code, and adds one
to its launch count. The plain PyTorch version of each kernel lives beside
its caller in ``ops/`` (``check_consistency_reference``,
``sampling_votes_reference``, ``raster_reference``); the public ops take it
only for tensors on the CPU.

Kernels:
  consistency     K1, csrc/consistency.cu  (ops/consistency.check_consistency)
  sampling_votes  K2, csrc/sampling.cu     (ops/point_sampling votes)
  raster          K3, csrc/raster.cu       (ops/rasterizer.render_sequence)
"""

from __future__ import annotations

import torch

from . import _build

KERNELS = ("consistency", "sampling_votes", "raster")
_launches = {k: 0 for k in KERNELS}


def launch_counts() -> dict:
    """Launches per kernel since the last reset (a copy)."""
    return dict(_launches)


def reset_launch_counts():
    for k in _launches:
        _launches[k] = 0


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(t: torch.Tensor, name: str, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _cams(K, R, t, n, device):
    _require(K, "K", torch.float32, (n, 3, 3), device)
    _require(R, "R", torch.float32, (n, 3, 3), device)
    _require(t, "t", torch.float32, (n, 3), device)


def consistency(disparity: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                t: torch.Tensor, *, min_dsp: float, max_dsp: float,
                reproj_err: float) -> torch.Tensor:
    """K1: [N,H,W] disparity filtered by the +-1-frame round trip."""
    if disparity.device.type != "cuda":
        raise ValueError("consistency kernel needs CUDA tensors")
    n, h, w = disparity.shape
    _require(disparity, "disparity", torch.float32, (n, h, w),
             disparity.device)
    _cams(K, R, t, n, disparity.device)
    out = torch.empty_like(disparity)
    lib = _build.load()
    err = lib.mvs_consistency(
        disparity.data_ptr(), K.data_ptr(), R.data_ptr(), t.data_ptr(),
        out.data_ptr(), n, h, w, float(min_dsp), float(max_dsp),
        float(reproj_err) * float(reproj_err), _stream(disparity))
    _build.check(lib, err, "consistency")
    _launches["consistency"] += 1
    return out


def sampling_votes(pts_s: torch.Tensor, disparity: torch.Tensor,
                   K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, *,
                   nbr_num: int, nbr_step: int, min_dsp: float,
                   max_dsp: float, dsp_err: float) -> torch.Tensor:
    """K2: agreement confidence [N,Hs,Ws] of the strided sample points
    pts_s [N,Hs,Ws,3] against the +-k*step neighbour frames."""
    if disparity.device.type != "cuda":
        raise ValueError("sampling_votes kernel needs CUDA tensors")
    n, h, w = disparity.shape
    dev = disparity.device
    _require(disparity, "disparity", torch.float32, (n, h, w), dev)
    if pts_s.dim() != 4 or pts_s.shape[0] != n or pts_s.shape[3] != 3:
        raise ValueError(f"pts_s: shape {tuple(pts_s.shape)}, expected "
                         f"[{n},Hs,Ws,3]")
    hs, ws = pts_s.shape[1:3]
    _require(pts_s, "pts_s", torch.float32, (n, hs, ws, 3), dev)
    _cams(K, R, t, n, dev)
    conf = torch.empty((n, hs, ws), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.mvs_sampling_votes(
        pts_s.data_ptr(), disparity.data_ptr(), K.data_ptr(), R.data_ptr(),
        t.data_ptr(), conf.data_ptr(), n, hs, ws, h, w, int(nbr_num),
        int(nbr_step), float(min_dsp), float(max_dsp), float(dsp_err),
        _stream(disparity))
    _build.check(lib, err, "sampling_votes")
    _launches["sampling_votes"] += 1
    return conf


def raster(uvz: torch.Tensor, faces: torch.Tensor, face_ok: torch.Tensor,
           *, height: int, width: int) -> torch.Tensor:
    """K3: z-max disparity [N,height,width] of faces [F,3] over per-frame
    projected vertices uvz [N,V,3] (u, v, 1/z); face_ok [N,F] bool."""
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
    if nf and (int(faces.min()) < 0 or int(faces.max()) >= v):
        raise ValueError("faces: vertex index out of range")
    zbuf = torch.zeros((n, height, width), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.mvs_raster(uvz.data_ptr(), faces.data_ptr(),
                         face_ok.data_ptr(), zbuf.data_ptr(), n, v, nf,
                         int(height), int(width), _stream(uvz))
    _build.check(lib, err, "raster")
    _launches["raster"] += 1
    return zbuf
