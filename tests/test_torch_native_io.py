"""The port's native IO (io/native_loader.py, built by g++ from its own
csrc/mvs_io.cpp into the git-ignored _build/) against the port's numpy
readers and the JAX package's native_loader: batch raw reads, npts, obj,
raw writes, the failing file's index, and ingest through the native
reader."""

import os
import subprocess

import numpy as np
import pytest

from multiviewstitch_tpu.io import native_loader as jnl
from multiviewstitch_tpu_torch.io import native_loader as nl
from multiviewstitch_tpu_torch.io.meshio import (read_npts, read_obj,
                                                 write_npts, write_obj)
from multiviewstitch_tpu_torch.io.rawdepth import (load_depth_raw,
                                                   save_depth_raw)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def require_native():
    assert nl.native_available(), "the native build failed (g++?)"


def test_library_lives_in_the_ignored_build_dir():
    rel = os.path.relpath(nl.LIB.path(), REPO)
    assert rel.startswith(os.path.join("multiviewstitch_tpu_torch",
                                       "_build"))
    assert os.path.exists(nl.LIB.path())
    assert subprocess.run(["git", "check-ignore", "-q", rel],
                          cwd=REPO).returncode == 0


def test_raw_batch_matches_numpy_and_jax(tmp_path):
    rng = np.random.default_rng(0)
    paths, ref = [], []
    for i in range(6):
        d = rng.uniform(0, 0.5, size=(24, 32)).astype(np.float32)
        p = str(tmp_path / f"_depth{i}.raw")
        save_depth_raw(p, d)
        paths.append(p)
        ref.append(load_depth_raw(p, 32, 24))
    before = nl.read_counts()
    out = nl.load_raw_batch(paths, 32, 24)
    assert nl.read_counts()["native"] == before["native"] + 1
    np.testing.assert_array_equal(out, np.stack(ref))
    np.testing.assert_array_equal(out, jnl.load_raw_batch(paths, 32, 24))
    assert nl.load_raw_batch([], 32, 24).shape == (0, 24, 32)


def test_raw_batch_names_the_failing_file(tmp_path):
    good = str(tmp_path / "a.raw")
    save_depth_raw(good, np.zeros((8, 8), np.float32))
    short = str(tmp_path / "short.raw")
    save_depth_raw(short, np.zeros((4, 8), np.float32))
    with pytest.raises(IOError, match="missing.raw"):
        nl.load_raw_batch([good, str(tmp_path / "missing.raw")], 8, 8)
    with pytest.raises(IOError, match="short.raw"):
        nl.load_raw_batch([good, short], 8, 8, num_threads=1)


def test_npts_matches_numpy_and_jax(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    nrm = rng.normal(size=(500, 3)).astype(np.float32)
    p = str(tmp_path / "a.npts")
    write_npts(p, pts, nrm)
    got = nl.parse_npts(p)
    for a, b, c in zip(got, read_npts(p), jnl.parse_npts(p)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
        np.testing.assert_array_equal(a, c)


def test_obj_matches_numpy_and_jax(tmp_path):
    rng = np.random.default_rng(2)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    n = rng.normal(size=(40, 3)).astype(np.float32)
    f = rng.integers(0, 40, size=(60, 3)).astype(np.int32)
    p = str(tmp_path / "m.obj")
    write_obj(p, v, n, f)
    got = nl.parse_obj(p)
    for a, b, c in zip(got, read_obj(p), jnl.parse_obj(p)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
        np.testing.assert_array_equal(a, c)


def test_write_raw_roundtrip(tmp_path):
    d = np.random.default_rng(3).normal(size=(16, 20)).astype(np.float32)
    p = str(tmp_path / "w.raw")
    nl.write_raw(p, d)
    np.testing.assert_array_equal(load_depth_raw(p, 20, 16), d)
    assert open(p, "rb").read() == d.tobytes()


def test_ingest_reads_depth_through_the_native_reader(tmp_path):
    import torch
    from multiviewstitch_tpu_torch.config import StitchConfig
    from multiviewstitch_tpu_torch.pipeline.align_seq import Sequence
    from multiviewstitch_tpu_torch.pipeline.fixtures import make_scene
    from multiviewstitch_tpu_torch.pipeline.ingest import (load_sequence_dir,
                                                           save_sequence_dir)
    sc = make_scene(n_frames=3, width=32, height=24, n_lat=12, n_lon=16,
                    arc_deg=30.0, device="cpu")
    save_sequence_dir(str(tmp_path / "s"), Sequence(
        torch.full_like(sc.disparity, 100.0), sc.disparity, sc.cams))
    nl.reset_read_counts()
    seq = load_sequence_dir(str(tmp_path / "s"), StitchConfig(),
                            device="cpu")
    assert nl.read_counts() == {"native": 1, "numpy": 0}
    assert torch.equal(seq.disparity, sc.disparity)
