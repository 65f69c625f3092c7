"""ctypes bindings of the native IO library (``csrc/mvs_io.cpp``).

The port's copy of ``multiviewstitch_tpu/io/native_loader.py``: threaded
batch raw-depth reads (the reference loads every depth map serially on
its main thread, Processor.cpp:35-40), npts / obj parsing and raw writes,
and the threaded OBJ / NPTS text writers behind ``io.meshio``
(``write_obj_native``, ``write_npts_native``: the bytes of meshio's
Python writers, formatted as ``csrc/mvs_io.cpp``'s header says).
At first use g++ builds the port's own copy of the source into the
git-ignored ``_build/`` directory beside the package (``_native.Library``,
keyed on the source, the flags and the host CPU's features). Where it
cannot be built or loaded, every function takes its numpy counterpart, as
the JAX package's do; ``native_available()`` says which, and
``read_counts()`` (a view of the counters ``io.native_reads.<reader>``)
counts the raw batches each reader served, so a run can show which one
ran. The writers return False where the library or its writers
(``mvs_writers_available``: floating-point ``std::to_chars``) are absent
or an array's dtype or shape is not covered, and ``io.meshio`` then
writes with Python; ``write_counts()`` (the counters
``io.native_writes.<writer>``) counts the files each writer wrote. The
build runs as the span ``io.native_build``. Host IO only: no device kernel.
"""

from __future__ import annotations

import ctypes
import os
import platform
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from .._native import Library
from ..utils.profiling import count, counters, reset_counters

GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
READS = "io.native_reads."      # the read counters' prefix
WRITES = "io.native_writes."    # the write counters' prefix

_P, _I, _I64, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_char_p
EXPORTS = {
    "mvs_load_raw_batch": (_I, (_P, _I, _I64, _P, _I)),
    "mvs_write_raw": (_I, (_S, _P, _I64)),
    "mvs_parse_npts": (_I64, (_S, _P, _I64)),
    "mvs_parse_obj_counts": (_I, (_S, _P, _P, _P)),
    "mvs_parse_obj": (_I, (_S, _P, _P, _P, _I64, _I64, _I64)),
    "mvs_writers_available": (_I, ()),
    "mvs_write_obj": (_I, (_S, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I)),
    "mvs_write_npts": (_I, (_S, _P, _P, _I64)),
}


def _cpu_tag() -> bytes:
    """The host CPU's feature flags (-march=native builds for them)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return platform.processor().encode()


def _compile(tmp: str) -> str:
    out = os.path.join(tmp, LIB.filename)
    subprocess.run(["g++", *GXX_FLAGS, "-o", out, *LIB.sources()],
                   check=True, capture_output=True, timeout=120)
    return out


LIB = Library("io", "libmvs_io.so", ("mvs_io.cpp",), GXX_FLAGS, EXPORTS,
              _compile, span="io.native_build", tag=_cpu_tag)
_failed = False


def _load_lib() -> Optional[ctypes.CDLL]:
    """The library, or None where it did not build or load (one attempt a
    process: every function then takes its numpy fallback)."""
    global _failed
    if _failed:
        return None
    try:
        return LIB.load()
    except (subprocess.SubprocessError, OSError):
        _failed = True
        return None


def native_available() -> bool:
    """Whether the native library built and loaded."""
    return _load_lib() is not None


def read_counts() -> dict:
    """Raw batches read by each reader ("native", "numpy") since the last
    reset (a copy)."""
    c = counters(READS)
    return {k: c.get(READS + k, 0) for k in ("native", "numpy")}


def reset_read_counts():
    reset_counters(READS)


def _count(reader: str):
    count(READS + reader)


def write_counts() -> dict:
    """Files written by each text writer ("native", "numpy") since the
    last reset (a copy)."""
    c = counters(WRITES)
    return {k: c.get(WRITES + k, 0) for k in ("native", "numpy")}


def reset_write_counts():
    reset_counters(WRITES)


def _ptr(a: Optional[np.ndarray]) -> Optional[int]:
    return None if a is None else a.ctypes.data


def load_raw_batch(paths: List[str], width: int, height: int,
                   num_threads: int = 8) -> np.ndarray:
    """N raw disparity files -> [N,H,W] float32 (the threaded native reader,
    numpy where it is not available). Raises IOError naming the first
    file that is missing or short."""
    lib = _load_lib()
    n = len(paths)
    if lib is None:
        from .rawdepth import load_depth_raw
        _count("numpy")
        return (np.stack([load_depth_raw(p, width, height) for p in paths])
                if n else np.zeros((0, height, width), np.float32))
    out = np.empty((n, height, width), np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = lib.mvs_load_raw_batch(arr, n, width * height, _ptr(out),
                                num_threads)
    if rc != 0:
        raise IOError(f"native raw batch load failed at {paths[rc - 1]}")
    _count("native")
    return out


def parse_npts(path: str, max_points: int = 50_000_000
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(points [P,3], normals [P,3]) of an npts file."""
    lib = _load_lib()
    if lib is None:
        from .meshio import read_npts
        return read_npts(path)
    # size the buffer from the file size (>= 6 floats of ~2 chars each)
    cap = min(max_points, max(os.path.getsize(path) // 12 + 16, 16))
    buf = np.empty((cap, 6), np.float32)
    n = lib.mvs_parse_npts(os.fsencode(path), _ptr(buf), cap)
    if n < 0:
        raise IOError(f"native npts parse failed: {path}")
    data = buf[:n]
    return data[:, :3].copy(), data[:, 3:].copy()


def parse_obj(path: str):
    """(vertices [V,3], normals [V,3] or None, faces [F,3] int32) of an
    OBJ file."""
    lib = _load_lib()
    if lib is None:
        from .meshio import read_obj
        return read_obj(path)
    nv, nn, nf = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if lib.mvs_parse_obj_counts(os.fsencode(path), ctypes.byref(nv),
                                ctypes.byref(nn), ctypes.byref(nf)):
        raise IOError(f"native obj parse failed: {path}")
    verts = np.empty((nv.value, 3), np.float32)
    normals = np.empty((nn.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    if lib.mvs_parse_obj(os.fsencode(path), _ptr(verts), _ptr(normals),
                         _ptr(faces), nv.value, nn.value, nf.value):
        raise IOError(f"native obj parse failed: {path}")
    return verts, (normals if nn.value else None), faces


def write_raw(path: str, data: np.ndarray):
    """Write a raster as raw float32."""
    lib = _load_lib()
    a = np.ascontiguousarray(data, np.float32)
    if lib is None:
        a.tofile(path)
        return
    if lib.mvs_write_raw(os.fsencode(path), _ptr(a), a.size):
        raise IOError(f"native raw write failed: {path}")


# dtype codes of csrc/mvs_io.cpp's mvs_write_obj
_FLOATS = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}
_INTS = {np.dtype(np.int32): 2, np.dtype(np.int64): 3}
_WIDE = {np.dtype(np.float64): 1, np.dtype(np.int64): 3}
_ABSENT = (None, 0)


def _rows3(a, codes, exact=False):
    """(C-contiguous first three columns of ``a``, dtype code), or None
    where the dtype is not covered or ``a`` is not [N,3] (``exact``) or
    [N,>=3]."""
    a = np.asarray(a)
    code = codes.get(a.dtype)
    if (code is None or a.ndim != 2 or a.shape[1] < 3
            or (exact and a.shape[1] != 3)):
        return None
    return np.ascontiguousarray(a[:, :3]), code


def _colors(colors):
    """Colours as int64 (integer dtypes but uint64) or float64 (floats up
    to double): the widened values print as the originals do."""
    c = np.asarray(colors)
    if c.dtype.kind in "iu" and c.dtype != np.uint64:
        c = c.astype(np.int64, copy=False)
    elif c.dtype.kind == "f" and c.dtype.itemsize <= 8:
        c = c.astype(np.float64, copy=False)
    return _rows3(c, _WIDE)


def _obj_arrays(verts, normals, faces, colors):
    """meshio.write_obj's choice of arrays as mvs_write_obj takes them:
    (verts, normals, colors, faces), each (array or None, code), or None
    where one of them is not covered."""
    n = len(verts)
    out = [_rows3(verts, _FLOATS), _ABSENT, _ABSENT, _ABSENT]
    if normals is not None and len(normals) == n:
        out[1] = _rows3(normals, _FLOATS)
    elif colors is not None:     # zip() would cut a shorter colour list
        out[2] = _colors(colors) if len(colors) == n else None
    if faces is not None and len(faces):
        out[3] = _rows3(faces, _INTS, exact=True)
    return None if any(a is None for a in out) else out


def _write_lib():
    lib = _load_lib()
    return lib if lib is not None and lib.mvs_writers_available() else None


def _wrote(path: str, rc: int) -> bool:
    if rc:
        raise OSError(rc, os.strerror(rc), path)
    count(WRITES + "native")
    return True


def write_obj_native(path: str, verts, normals=None, faces=None,
                     colors=None) -> bool:
    """Write ``io.meshio.write_obj``'s OBJ text natively, byte for byte:
    verts and normals float32 / float64, faces int32 / int64 [F,3] (None or
    empty: no ``f`` lines), colours integer or float. Normals are used
    where their length is the vertices', colours where there are no
    normals. Returns False, having written nothing, where the library or
    its writers are absent or an array is not covered; raises OSError
    where the file cannot be written."""
    lib = _write_lib()
    arrays = None if lib is None else _obj_arrays(np.asarray(verts),
                                                  normals, faces, colors)
    if arrays is None:
        count(WRITES + "numpy")
        return False
    (v, vc), (nr, nc), (co, cc), (fc, fcc) = arrays
    return _wrote(path, lib.mvs_write_obj(
        os.fsencode(path), _ptr(v), _ptr(nr), _ptr(co), _ptr(fc), len(v),
        0 if fc is None else len(fc), vc, nc, cc, fcc))


def write_npts_native(path: str, points, normals) -> bool:
    """Write ``io.meshio.write_npts``'s NPTS text natively, byte for byte:
    points and normals [N,3], cast to float32 as meshio does. Returns
    False, having written nothing, where the library or its writers are
    absent or the shapes are not [N,3]; raises OSError where the file
    cannot be written."""
    lib = _write_lib()
    pts = np.ascontiguousarray(points, np.float32)
    nrm = np.ascontiguousarray(normals, np.float32)
    if (lib is None or pts.ndim != 2 or pts.shape[1] != 3
            or nrm.shape != pts.shape):
        count(WRITES + "numpy")
        return False
    return _wrote(path, lib.mvs_write_npts(os.fsencode(path), _ptr(pts),
                                           _ptr(nrm), len(pts)))
