"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into ONE shared library with a plain
C interface, loaded with ``ctypes``. Nothing here runs at import time:
the first CUDA call builds (or finds) the library. The build directory is
keyed on a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one is reused.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` — without it
nvcc contracts ``a*b+c`` into one fused multiply-add, while each PyTorch
elementwise op rounds on its own, which moves ``floor(x+0.5)`` ties and
edge-function signs at exactly zero between a kernel and its plain version.

``build`` runs as the span ``kernels.build`` and counts ``kernels.built``
when this process ran nvcc (``utils.profiling``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..utils.profiling import count, span

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_CSRC), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature of every exported launcher: (argtypes); all return cudaError_t
_SIGNATURES = {
    # disp, K, R, t, out, n, h, w, offsets (host int32), n_offsets, min_dsp,
    # max_dsp, reproj_err^2, stream
    "mvs_consistency": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _F, _F, _F,
                        _P),
    # disp, K, R, t, centers, points, normals, conf, valid, n, h, w,
    # sample_radius, nbr_num, nbr_step, min_dsp, max_dsp, dsp_err, conf_min,
    # stream
    "mvs_oriented_points": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _F, _F, _F, _F, _P),
    # uvz, faces, face_ok, rec, meta (+ counts), start, items, item_cap,
    # bins, capacity, zbuf, n_frames, n_verts, n_faces, h, w, stream
    "mvs_raster": (_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I,
                   _I, _I, _P),
    # x, b (null for the matvec), out, G, mode, -screen, omega, 1 / diag,
    # stream
    "mvs_stencil_sweep": (_P, _P, _P, _I, _I, _F, _F, _F, _P),
    # x, b, G, iters, -screen, omega, 1 / diag, stream
    "mvs_stencil_coarsest": (_P, _P, _I, _I, _F, _F, _F, _P),
    # x, e, G, stream
    "mvs_stencil_prolong": (_P, _P, _I, _P),
    # a, out, G, axis, 1 / 3, stream
    "mvs_stencil_blur": (_P, _P, _I, _I, _F, _P),
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16], "libmvs_kernels.so")


def _run_all(cmds, verbose: bool):
    """Run the commands as processes started together; raise with the
    output of those that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        logs = [p.communicate()[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"{' '.join(c)}\n{log}" for c, p, log in zip(cmds, procs, logs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    if verbose and any(logs):
        print("".join(logs), flush=True)


def build(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into the hash-keyed library (no-op if present):
    one nvcc process per source, all started together, then one link.
    ``verbose`` prints ptxas's register and spill report. Returns the
    library path."""
    with span("kernels.build"):
        out = library_path()
        if not os.path.exists(out):
            _compile(out, verbose)
    return out


def _compile(out: str, verbose: bool):
    nvcc = _nvcc()
    tmp = f"{out}.{os.getpid()}.tmp"
    os.makedirs(tmp, exist_ok=True)
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in cus]
    lib = os.path.join(tmp, "lib.so")
    ptxas = ["-Xptxas=-v"] if verbose else []
    try:
        _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", src, "-o", obj]
                  for src, obj in zip(cus, objs)], verbose)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]], False)
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    count("kernels.built")


def load():
    """The loaded ``ctypes`` library with every launcher's signature set.
    Builds on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.mvs_error_string.argtypes = [ctypes.c_int]
            lib.mvs_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(lib, err: int, name: str):
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.mvs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
