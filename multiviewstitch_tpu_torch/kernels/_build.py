"""The nvcc build of the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into ONE shared library with a plain
C interface, loaded with ``ctypes`` (``_native.Library``: the key, the
build directory, the lock and the load). The first CUDA call builds (or
finds) the library; without nvcc, ``load`` raises ``RuntimeError``.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` — without it
nvcc contracts ``a*b+c`` into one fused multiply-add, while each PyTorch
elementwise op rounds on its own, which moves ``floor(x+0.5)`` ties and
edge-function signs at exactly zero between a kernel and its plain version.

The build runs as the span ``kernels.build`` and counts ``kernels.built``
when this process ran nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

from .._native import Library

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_E = ctypes.c_int       # every launcher returns a cudaError_t

EXPORTS = {
    # disp, K, R, t, out, n, h, w, offsets (host int32), n_offsets, min_dsp,
    # max_dsp, reproj_err^2, stream
    "mvs_consistency": (_E, (_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _F, _F,
                             _F, _P)),
    # disp, K, R, t, centers, points, normals, conf, valid, n, h, w,
    # sample_radius, nbr_num, nbr_step, min_dsp, max_dsp, dsp_err, conf_min,
    # stream
    "mvs_oriented_points": (_E, (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _F, _F, _F, _F, _P)),
    # uvz, faces, face_ok, rec, meta (+ counts), start, items, item_cap,
    # bins, capacity, zbuf, n_frames, n_verts, n_faces, h, w, stream
    "mvs_raster": (_E, (_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I,
                        _I, _I, _I, _P)),
    # x, b (null for the matvec), out, G, mode, -screen, omega, 1 / diag,
    # stream
    "mvs_stencil_sweep": (_E, (_P, _P, _P, _I, _I, _F, _F, _F, _P)),
    # x, b, G, iters, -screen, omega, 1 / diag, stream
    "mvs_stencil_coarsest": (_E, (_P, _P, _I, _I, _F, _F, _F, _P)),
    # x, e, G, stream
    "mvs_stencil_prolong": (_E, (_P, _P, _I, _P)),
    # a, out, G, axis, 1 / 3, stream
    "mvs_stencil_blur": (_E, (_P, _P, _I, _I, _F, _P)),
    "mvs_error_string": (ctypes.c_char_p, (_E,)),
}


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


def _compile(tmp: str, verbose: bool = False) -> str:
    """One nvcc process per ``.cu`` into ``tmp``, all started together,
    then one link; ``verbose`` prints ptxas's register and spill report.
    Returns the linked library."""
    nvcc = _nvcc()
    cus = [p for p in LIB.sources() if p.endswith(".cu")]
    objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in cus]
    lib = os.path.join(tmp, "lib.so")
    ptxas = ["-Xptxas=-v"] if verbose else []
    _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", src, "-o", obj]
              for src, obj in zip(cus, objs)], verbose)
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]], False)
    return lib


LIB = Library("kernels", "libmvs_kernels.so", ("*.cu", "*.cuh"), NVCC_FLAGS,
              EXPORTS, _compile, span="kernels.build")
load = LIB.load


def check(lib, err: int, name: str):
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.mvs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
