"""The port's one native-code layer (``_native.Library``) and the two
libraries on it: a build installs its file by rename and a second build
reuses it; a library's key follows its own sources; and each library's
failure policy, with its compiler made to fail or hidden (the IO library
falls back to numpy, the kernels raise naming nvcc). Each case builds
under a temporary ``BUILD_ROOT``, so none touches the package's
``_build/`` and the cases hold on a host with g++ and nvcc too."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from multiviewstitch_tpu_torch import _native
from multiviewstitch_tpu_torch.io import native_loader as nl
from multiviewstitch_tpu_torch.io.rawdepth import save_depth_raw
from multiviewstitch_tpu_torch.kernels import _build
from multiviewstitch_tpu_torch.utils.profiling import counters

# a stand-in compiler: writes its second argument's bytes to its first
_WRITE = "import sys; open(sys.argv[1], 'wb').write(sys.argv[2].encode())"


@pytest.fixture
def build_root(tmp_path, monkeypatch):
    root = tmp_path / "_build"
    monkeypatch.setattr(_native, "BUILD_ROOT", str(root))
    return root


def test_build_installs_by_rename_and_reuses_the_file(tmp_path, monkeypatch,
                                                      build_root):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "demo.c").write_text("int demo;\n")
    monkeypatch.setattr(_native, "CSRC", str(src))
    runs = []

    def compile(tmp, text="built"):
        out = os.path.join(tmp, "lib.so")
        subprocess.run([sys.executable, "-c", _WRITE, out, text], check=True)
        runs.append(tmp)
        return out

    lib = _native.Library("demo", "libdemo.so", ("*.c",), ("-O2",), {},
                          compile, span="demo.build")
    before = counters("demo.built").get("demo.built", 0)
    path = lib.build(text="first")
    assert path == lib.path()
    assert os.path.dirname(path).startswith(str(build_root / "demo-"))
    with open(path) as f:
        assert f.read() == "first"
    assert os.listdir(os.path.dirname(path)) == ["libdemo.so"]
    assert not os.path.exists(runs[0])       # the temporary directory
    assert lib.build(text="second") == path  # found, not compiled again
    with open(path) as f:
        assert f.read() == "first"
    assert len(runs) == 1
    assert counters("demo.built")["demo.built"] == before + 1


@pytest.mark.parametrize("owner,source", [("kernels", "stencil.cu"),
                                          ("io", "mvs_io.cpp")])
def test_a_library_key_follows_its_own_sources(tmp_path, monkeypatch, owner,
                                               source):
    libs = {"kernels": _build.LIB, "io": nl.LIB}
    package = {k: lib.path() for k, lib in libs.items()}
    assert package["kernels"] != package["io"]
    src = tmp_path / "csrc"
    shutil.copytree(_native.CSRC, src)
    monkeypatch.setattr(_native, "CSRC", str(src))
    # the key is the sources' names and bytes, not where they lie
    assert {k: lib.path() for k, lib in libs.items()} == package
    data = bytearray((src / source).read_bytes())
    data[-1] ^= 1
    (src / source).write_bytes(bytes(data))
    for k, lib in libs.items():
        assert (lib.path() != package[k]) == (k == owner), k


def test_io_library_that_fails_to_build_leaves_numpy(tmp_path, monkeypatch,
                                                     build_root):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\necho 'g++: failed' >&2\nexit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(nl.LIB, "_lib", None)
    monkeypatch.setattr(nl, "_failed", False)
    assert not nl.native_available()
    assert not os.path.exists(nl.LIB.path())
    d = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = str(tmp_path / "_depth0.raw")
    save_depth_raw(p, d)
    before = nl.read_counts()
    np.testing.assert_array_equal(nl.load_raw_batch([p], 4, 3), d[None])
    assert nl.read_counts() == {"native": before["native"],
                                "numpy": before["numpy"] + 1}


def test_kernel_library_without_nvcc_raises(tmp_path, monkeypatch,
                                            build_root):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build.LIB, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()
    assert not os.path.exists(_build.LIB.path())
