"""The port's own OBJ / NPTS writers and readers and stage manifest against
the JAX package's, on the same numpy arrays made from a seed.

Tolerance: none — the files are byte-identical and the readers return
equal arrays."""

import numpy as np
import pytest

from multiviewstitch_tpu.io import manifest as jman
from multiviewstitch_tpu.io import meshio as jmesh
from multiviewstitch_tpu_torch.io import manifest as tman
from multiviewstitch_tpu_torch.io import meshio as tmesh


def _mesh(seed=0, n_verts=50, n_faces=70):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(n_verts, 3)).astype(np.float32)
    normals = rng.normal(size=(n_verts, 3)).astype(np.float32)
    faces = rng.integers(0, n_verts, size=(n_faces, 3)).astype(np.int32)
    colors = rng.integers(0, 256, size=(n_verts, 3))
    return verts, normals, faces, colors


@pytest.mark.parametrize("case", ["faces", "normals", "colors", "points",
                                  "no faces"])
def test_write_obj_is_byte_identical_to_jax(tmp_path, case):
    verts, normals, faces, colors = _mesh()
    kw = {"faces": dict(faces=faces),
          "normals": dict(normals=normals, faces=faces),
          "colors": dict(colors=colors, faces=faces),
          "points": {},
          "no faces": dict(normals=normals, faces=faces[:0])}[case]
    tmesh.write_obj(str(tmp_path / "t.obj"), verts, **kw)
    jmesh.write_obj(str(tmp_path / "j.obj"), verts, **kw)
    got = (tmp_path / "t.obj").read_bytes()
    assert got == (tmp_path / "j.obj").read_bytes()
    assert len(got) > 0
    tv, tn, tf = tmesh.read_obj(str(tmp_path / "t.obj"))
    jv, jn, jf = jmesh.read_obj(str(tmp_path / "j.obj"))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert (tn is None) == (jn is None)
    if case != "colors":       # a coloured v line holds six numbers
        np.testing.assert_array_equal(tv, verts)
    if case in ("faces", "normals", "colors"):
        np.testing.assert_array_equal(tf, faces)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_write_npts_is_byte_identical_to_jax(tmp_path, dtype):
    verts, normals, _, _ = _mesh(seed=1)
    tmesh.write_npts(str(tmp_path / "t.npts"), verts.astype(dtype),
                     normals.astype(dtype))
    jmesh.write_npts(str(tmp_path / "j.npts"), verts.astype(dtype),
                     normals.astype(dtype))
    assert (tmp_path / "t.npts").read_bytes() == \
        (tmp_path / "j.npts").read_bytes()
    tp, tn = tmesh.read_npts(str(tmp_path / "t.npts"))
    jp, jn = jmesh.read_npts(str(tmp_path / "j.npts"))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(tp, verts, rtol=1e-7)


def test_manifest_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    arrays = dict(a=rng.normal(size=(4, 5)).astype(np.float32),
                  b=np.arange(7, dtype=np.int64))
    assert tman.hash_arrays(**arrays) == jman.hash_arrays(**arrays)
    out = tmp_path / "Result" / "x.txt"
    m = tman.StageManifest(str(tmp_path))
    m.stage_dir("Result")
    out.write_text("payload")
    h = tman.hash_arrays(**arrays)
    m.mark_done("align", [str(out)], input_hash=h, metrics={"points": 3})
    # a manifest the port writes reads back the same in either package
    for cls in (tman.StageManifest, jman.StageManifest):
        again = cls(str(tmp_path))
        assert again.is_done("align", h)
        assert not again.is_done("align", "other")
        assert again.metrics("align") == {"points": 3.0}
    out.write_text("changed")
    assert not tman.StageManifest(str(tmp_path)).is_done("align", h)
