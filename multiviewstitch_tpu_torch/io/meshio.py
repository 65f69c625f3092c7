"""Mesh / oriented-point-cloud file IO (OBJ, NPTS).

The port's own copy of ``multiviewstitch_tpu/io/meshio.py`` (numpy only);
``tests/test_torch_io.py`` holds its files byte-identical to the JAX
package's.

Host-side numpy equivalents of the reference's ``PlyObj/PlyObj.{h,cpp}``:
  - OBJ read: ``v``, ``vn``, ``f a//b`` forms (PlyObj.cpp:29-75)
  - OBJ write: interleaved vn+v then faces (PlyObj.cpp:77-137)
  - NPTS: one oriented point per line ``x y z nx ny nz`` as written by the
    reference's point sampler and read back at Processor.cpp:952-964.
Vertex/face arrays are numpy. The writers write through the native
library's threaded text writers (``io.native_loader.write_obj_native`` /
``write_npts_native``, built from ``csrc/mvs_io.cpp``), which give the
same bytes: a float of a ``v`` / ``vn`` / colour field prints as
``f"{x}"`` of its numpy scalar (``repr`` of the value widened to double),
an integer in decimal, an NPTS value as ``"%.8g"``. Where the library,
its writers or an array's dtype are not covered, the Python loops below
write the file (``io.native_loader.write_counts()`` says which ran). Each
writer runs as a span (``io.write_obj``, ``io.write_npts``) and counts its
bytes (``io.bytes.<file name>``) and rows (``io.vertices`` and
``io.faces``; ``io.points``) with ``utils.profiling``.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.profiling import count, span
from . import native_loader


def read_obj(path: str):
    """Read an OBJ file -> (vertices [V,3] f32, normals [Vn,3] f32 or None,
    faces [F,3] i32, 0-based).

    Accepts the forms the reference writes/reads (PlyObj.cpp:29-75):
    ``v x y z``, ``vn x y z``, ``f a b c``, ``f a//b ...``, ``f a/b/c ...``.
    """
    verts, normals, faces = [], [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:4]]
                faces.append(idx)
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    n = np.asarray(normals, np.float32).reshape(-1, 3) if normals else None
    f_ = np.asarray(faces, np.int64)
    # OBJ indices are 1-based (negative = relative)
    f_ = np.where(f_ > 0, f_ - 1, len(verts) + f_).astype(np.int32).reshape(-1, 3)
    return v, n, f_


def write_obj(path: str, verts, normals=None, faces=None, colors=None):
    """Write OBJ. With normals, interleaves ``vn``+``v`` per vertex and emits
    ``f a//a b//b c//c`` like the reference (PlyObj.cpp:98-136); with colors,
    appends r g b to each ``v`` line (colored-point export,
    PlyObj.h:358-390)."""
    name = os.path.basename(path)
    with span("io.write_obj", file=name):
        _write_obj(path, verts, normals, faces, colors)
        count("io.bytes." + name, os.path.getsize(path))


def _write_obj(path, verts, normals, faces, colors):
    verts = np.asarray(verts)
    faces = None if faces is None or len(faces) == 0 else np.asarray(faces)
    count("io.vertices", len(verts))
    count("io.faces", 0 if faces is None else len(faces))
    if native_loader.write_obj_native(path, verts, normals, faces, colors):
        return
    with open(path, "w") as f:
        if normals is not None and len(normals) == len(verts):
            normals = np.asarray(normals)
            for p, n in zip(verts, normals):
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
                f.write(f"v {p[0]} {p[1]} {p[2]}\n")
            if faces is not None:
                for a, b, c in faces + 1:
                    f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
        else:
            if colors is not None:
                for p, c in zip(verts, np.asarray(colors)):
                    f.write(f"v {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                for p in verts:
                    f.write(f"v {p[0]} {p[1]} {p[2]}\n")
            if faces is not None:
                for a, b, c in faces + 1:
                    f.write(f"f {a} {b} {c}\n")


def read_npts(path: str):
    """Read oriented points: lines of ``x y z nx ny nz``
    -> (points [N,3] f32, normals [N,3] f32). (Processor.cpp:952-964)"""
    data = np.loadtxt(path, dtype=np.float32).reshape(-1, 6)
    return data[:, :3], data[:, 3:]


def write_npts(path: str, points, normals):
    """Write oriented points in the reference's npts format
    (Result/PSR.npts writer, Processor.cpp:1033-1040)."""
    name = os.path.basename(path)
    with span("io.write_npts", file=name):
        pts = np.asarray(points, np.float32)
        nrm = np.asarray(normals, np.float32)
        if not native_loader.write_npts_native(path, pts, nrm):
            np.savetxt(path, np.concatenate([pts, nrm], axis=1), fmt="%.8g")
        count("io.points", len(pts))
        count("io.bytes." + name, os.path.getsize(path))
