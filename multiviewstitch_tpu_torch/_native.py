"""Build and load the port's native libraries (sources in ``csrc/``).

How native code is built and loaded is decided here once: the
git-ignored ``_build/`` root beside the package; the key that names a
build (sha256 of the compiler flags, an extra tag such as the host CPU's
flags, then each source's name and bytes), so an edited source or flag
rebuilds and an unchanged one is reused; the compile into a temporary
directory whose result is renamed into place, so a concurrent build
never loads a partial file; one lock and one load a library; and the
``restype`` / ``argtypes`` of every export, from one table. Nothing here
runs at import time.

Each library declares the rest beside the code that calls it:

  kernels/_build.py    nvcc, K1-K4 (``csrc/*.cu``); no nvcc raises
  io/native_loader.py  g++, ``csrc/mvs_io.cpp``; a failed build or load
                       leaves every function on its numpy fallback

A build runs as the library's span (``kernels.build``,
``io.native_build``) and counts ``<name>.built`` (``kernels.built``,
``io.built``) when this process ran the compiler (``utils.profiling``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import threading
from typing import Callable, Sequence

from .utils.profiling import count, span

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")


class Library:
    """One native library: the sources in ``CSRC`` matching ``patterns``,
    built by ``compile(tmp_dir, **kw)`` (which returns the built file
    inside ``tmp_dir``) into ``BUILD_ROOT/<name>-<key>/<filename>``;
    ``exports`` maps each exported name to its (restype, argtypes)."""

    def __init__(self, name: str, filename: str, patterns: Sequence[str],
                 flags: Sequence[str], exports: dict,
                 compile: Callable[..., str], *, span: str,
                 tag: Callable[[], bytes] = bytes):
        self.name, self.filename = name, filename
        self.patterns, self.flags = tuple(patterns), tuple(flags)
        self.exports, self.compile = exports, compile
        self.span, self.tag = span, tag
        self._lock = threading.Lock()
        self._lib = None

    def sources(self):
        """The library's sources, sorted."""
        return sorted({p for pat in self.patterns
                       for p in glob.glob(os.path.join(CSRC, pat))})

    def path(self) -> str:
        """Where the library for the current sources, flags and tag
        lives."""
        h = hashlib.sha256(" ".join(self.flags).encode() + self.tag())
        for p in self.sources():
            h.update(os.path.basename(p).encode())
            with open(p, "rb") as f:
                h.update(f.read())
        return os.path.join(BUILD_ROOT, f"{self.name}-{h.hexdigest()[:16]}",
                            self.filename)

    def build(self, **kw) -> str:
        """Compile the library unless it is there (``kw`` goes to
        ``compile``); returns its path."""
        with span(self.span):
            out = self.path()
            if not os.path.exists(out):
                tmp = f"{out}.{os.getpid()}.tmp"
                os.makedirs(tmp, exist_ok=True)
                try:
                    os.replace(self.compile(tmp, **kw), out)
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)
                count(self.name + ".built")
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded library with every export's types set; builds on
        first use. Raises what the build or the load raised."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                for name, (restype, argtypes) in self.exports.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, list(argtypes)
                self._lib = lib
        return self._lib
