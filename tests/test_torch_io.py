"""The port's own OBJ / NPTS writers and readers and stage manifest against
the JAX package's, on the same numpy arrays made from a seed. Each writer
case runs twice: through the native writers (``io.native_loader``) and
with the library forced off (the Python fallback).

Tolerance: none — the files are byte-identical and the readers return
equal arrays."""

import numpy as np
import pytest

from multiviewstitch_tpu.io import manifest as jman
from multiviewstitch_tpu.io import meshio as jmesh
from multiviewstitch_tpu_torch.io import manifest as tman
from multiviewstitch_tpu_torch.io import meshio as tmesh
from multiviewstitch_tpu_torch.io import native_loader as nl

WRITERS = ("native", "numpy")


def _by_writer(cases, ids=None):
    """Each case through the native writer (the case's own id) and the
    Python fallback (``<id>-numpy``)."""
    ids = ids or [str(c) for c in cases]
    return [pytest.param(c, w, id=i if w == "native" else f"{i}-{w}")
            for w in WRITERS for c, i in zip(cases, ids)]


@pytest.fixture
def use_writer(monkeypatch):
    """Select a writer; on exit, check it wrote every file it was given."""
    state = {}

    def use(writer):
        if writer == "numpy":
            monkeypatch.setattr(nl, "_load_lib", lambda: None)
        else:
            assert nl.native_available()
            assert nl._load_lib().mvs_writers_available()
        state.update(writer=writer, before=nl.write_counts())
    yield use
    after = nl.write_counts()
    other = "numpy" if state["writer"] == "native" else "native"
    assert after[state["writer"]] > state["before"][state["writer"]]
    assert after[other] == state["before"][other]


def _same_obj(tmp_path, verts, **kw):
    tmesh.write_obj(str(tmp_path / "t.obj"), verts, **kw)
    jmesh.write_obj(str(tmp_path / "j.obj"), verts, **kw)
    got = (tmp_path / "t.obj").read_bytes()
    assert got == (tmp_path / "j.obj").read_bytes()
    return got


def _same_npts(tmp_path, points, normals):
    tmesh.write_npts(str(tmp_path / "t.npts"), points, normals)
    jmesh.write_npts(str(tmp_path / "j.npts"), points, normals)
    got = (tmp_path / "t.npts").read_bytes()
    assert got == (tmp_path / "j.npts").read_bytes()
    return got


def _mesh(seed=0, n_verts=50, n_faces=70):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(n_verts, 3)).astype(np.float32)
    normals = rng.normal(size=(n_verts, 3)).astype(np.float32)
    faces = rng.integers(0, n_verts, size=(n_faces, 3)).astype(np.int32)
    colors = rng.integers(0, 256, size=(n_verts, 3))
    return verts, normals, faces, colors


@pytest.mark.parametrize("case,writer", _by_writer(
    ["faces", "normals", "colors", "points", "no faces"]))
def test_write_obj_is_byte_identical_to_jax(tmp_path, use_writer, case,
                                            writer):
    use_writer(writer)
    verts, normals, faces, colors = _mesh()
    kw = {"faces": dict(faces=faces),
          "normals": dict(normals=normals, faces=faces),
          "colors": dict(colors=colors, faces=faces),
          "points": {},
          "no faces": dict(normals=normals, faces=faces[:0])}[case]
    got = _same_obj(tmp_path, verts, **kw)
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


@pytest.mark.parametrize("dtype,writer", _by_writer(
    [np.float32, np.float64], ["dtype0", "dtype1"]))
def test_write_npts_is_byte_identical_to_jax(tmp_path, use_writer, dtype,
                                             writer):
    use_writer(writer)
    verts, normals, _, _ = _mesh(seed=1)
    _same_npts(tmp_path, verts.astype(dtype), normals.astype(dtype))
    tp, tn = tmesh.read_npts(str(tmp_path / "t.npts"))
    jp, jn = jmesh.read_npts(str(tmp_path / "j.npts"))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(tp, verts, rtol=1e-7)


def _edge_values(dtype):
    """Values where the text's form changes or rounding is hard: +-0, 1e-4
    and 1e16 (the positional / scientific switch) with their float32
    neighbours either side, subnormals, integral floats, the largest
    magnitudes, nan and +-inf; float64 adds its own neighbours of 1e-4 and
    1e16 and values past float32's range."""
    f32 = np.float32
    base = [0.0, 1e-4, 1e16, 1e-5, 1.5e16, 1.0, 2.0, 100.0, 1e15, 123456.0,
            16777217.0, 1.17549435e-38, 1e-45, 3.4028235e38, 0.1]
    vals = []
    with np.errstate(over="ignore"):       # float32's largest steps to inf
        for x in base:
            for s in (1, -1):
                x32 = f32(s * x)
                vals += [x32, np.nextafter(x32, f32(np.inf)),
                         np.nextafter(x32, f32(-np.inf))]
    vals += [np.nan, -np.nan, np.inf, -np.inf]
    v = np.asarray(vals, np.float32).astype(dtype)
    if dtype == np.float64:
        v = np.concatenate([v, [1e-4, np.nextafter(1e-4, 0),
                                np.nextafter(1e-4, 1), 1e16, -1e16,
                                np.nextafter(1e16, 0), 5e-324, 1e308,
                                -2.5e-310, 1 / 3, 9007199254740993.0]])
    return np.resize(v, (-(-len(v) // 3), 3))


@pytest.mark.parametrize("dtype,writer", _by_writer(
    [np.float32, np.float64], ["float32", "float64"]))
def test_write_edge_values_are_byte_identical_to_jax(tmp_path, use_writer,
                                                     dtype, writer):
    use_writer(writer)
    verts = _edge_values(dtype)
    itype = np.int32 if dtype == np.float32 else np.int64
    info = np.iinfo(itype)
    faces = np.asarray([[0, 1, 2], [info.max - 1, 0, info.max - 2],
                        [-1, -2, 3]], itype)
    for kw in (dict(faces=faces), dict(normals=verts[::-1], faces=faces),
               dict(colors=verts), dict(colors=verts[:, :3].view(itype))):
        _same_obj(tmp_path, verts, **kw)
    with np.errstate(over="ignore"):    # float64 past float32's range
        _same_npts(tmp_path, verts, verts[::-1])


@pytest.mark.parametrize("writer", WRITERS)
def test_write_empty_arrays_is_byte_identical_to_jax(tmp_path, use_writer,
                                                     writer):
    use_writer(writer)
    empty = np.zeros((0, 3), np.float32)
    assert _same_obj(tmp_path, empty) == b""
    assert _same_obj(tmp_path, empty, normals=empty,
                     faces=np.zeros((0, 3), np.int32)) == b""
    assert _same_npts(tmp_path, empty, empty) == b""


def test_native_write_of_a_large_mesh_is_byte_identical_to_jax(
        tmp_path, use_writer):
    """200k vertices and 300k faces: several of the writer's chunks, one
    thread each, joined in order."""
    use_writer("native")
    rng = np.random.default_rng(3)
    n = 200_000
    scale = 10.0 ** rng.integers(-6, 18, size=(n, 3))
    verts = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    faces = rng.integers(0, n, size=(300_000, 3)).astype(np.int32)
    _same_obj(tmp_path, verts, normals=verts[::-1], faces=faces)
    _same_npts(tmp_path, verts, verts[::-1])


def test_write_counts_name_the_writer(tmp_path, monkeypatch):
    verts, normals, faces, _ = _mesh()
    before = nl.write_counts()
    tmesh.write_obj(str(tmp_path / "a.obj"), verts, faces=faces)
    tmesh.write_npts(str(tmp_path / "a.npts"), verts, normals)
    native = nl.write_counts()
    assert native == {"native": before["native"] + 2,
                      "numpy": before["numpy"]}
    # a dtype the native writer does not take goes to the Python writer
    tmesh.write_obj(str(tmp_path / "h.obj"), verts.astype(np.float16))
    jmesh.write_obj(str(tmp_path / "j.obj"), verts.astype(np.float16))
    assert (tmp_path / "h.obj").read_bytes() == \
        (tmp_path / "j.obj").read_bytes()
    assert nl.write_counts()["numpy"] == native["numpy"] + 1
    monkeypatch.setattr(nl, "_load_lib", lambda: None)
    tmesh.write_obj(str(tmp_path / "b.obj"), verts, faces=faces)
    tmesh.write_npts(str(tmp_path / "b.npts"), verts, normals)
    assert nl.write_counts() == {"native": native["native"],
                                 "numpy": native["numpy"] + 3}
    assert (tmp_path / "a.obj").read_bytes() == \
        (tmp_path / "b.obj").read_bytes()
    assert (tmp_path / "a.npts").read_bytes() == \
        (tmp_path / "b.npts").read_bytes()


@pytest.mark.parametrize("writer", WRITERS)
def test_write_to_a_missing_directory_raises(tmp_path, monkeypatch, writer):
    if writer == "numpy":
        monkeypatch.setattr(nl, "_load_lib", lambda: None)
    verts, normals, faces, _ = _mesh()
    with pytest.raises(FileNotFoundError):
        tmesh.write_obj(str(tmp_path / "no" / "t.obj"), verts, faces=faces)
    with pytest.raises(FileNotFoundError):
        tmesh.write_npts(str(tmp_path / "no" / "t.npts"), verts, normals)


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
