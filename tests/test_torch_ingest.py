"""--config ingest: the port's .act parser, raw disparity IO, sequence
directories and legacy-config loading against the JAX package, on the
reference's on-disk layout (tests/test_ingest.py's 96x72 demo sequences).

Tolerance: none. Cameras and disparities are equal after a round trip in
either direction (the .act text holds each float32's shortest repr); the
grey frames are equal, since both packages decode the same file with the
same PIL; the files the two writers produce are byte-identical."""

import os

import numpy as np
import pytest
import torch

from multiviewstitch_tpu.config import StitchConfig as JConfig
from multiviewstitch_tpu.config import load_legacy_config as j_load_config
from multiviewstitch_tpu.core.cameras import load_act as j_load_act
from multiviewstitch_tpu.core.cameras import save_act as j_save_act
from multiviewstitch_tpu.io import rawdepth as jraw
from multiviewstitch_tpu.pipeline import ingest as jing
from multiviewstitch_tpu_torch.config import StitchConfig, load_legacy_config
from multiviewstitch_tpu_torch.core.cameras import load_act, save_act
from multiviewstitch_tpu_torch.interop import sequence_from_numpy
from multiviewstitch_tpu_torch.io import rawdepth as traw
from multiviewstitch_tpu_torch.pipeline import ingest as ting
from multiviewstitch_tpu_torch.pipeline.executor import prefetch_map

torch.set_num_threads(2)

W, H, N = 96, 72, 3


@pytest.fixture(scope="module")
def jseqs():
    from test_e2e_align import build_two_sequences
    seq1, seq2, *_ = build_two_sequences(n_frames=N, width=W, height=H)
    return seq1, seq2


def _port_seq(js):
    c = js.cams
    return sequence_from_numpy(np.asarray(js.gray), np.asarray(js.disparity),
                               np.asarray(c.K), np.asarray(c.R),
                               np.asarray(c.t), c.width, c.height, "cpu")


def _assert_seq_equal(t, j):
    """Port Sequence t against JAX Sequence j: every array equal."""
    np.testing.assert_array_equal(t.disparity.numpy(),
                                  np.asarray(j.disparity))
    np.testing.assert_array_equal(t.gray.numpy(), np.asarray(j.gray))
    for a in ("K", "R", "t"):
        np.testing.assert_array_equal(getattr(t.cams, a).numpy(),
                                      np.asarray(getattr(j.cams, a)))
    assert (t.cams.width, t.cams.height) == (j.cams.width, j.cams.height)


def test_act_parse_matches_jax(tmp_path, jseqs):
    cams = jseqs[1].cams
    path = str(tmp_path / "c.act")
    j_save_act(path, cams, start=3, step=2)
    t = load_act(path, device="cpu")
    j = j_load_act(path)
    assert (t.width, t.height) == (j.width, j.height) == (W, H)
    for a in ("K", "R", "t"):
        np.testing.assert_array_equal(getattr(t, a).numpy(),
                                      np.asarray(getattr(j, a)))
        np.testing.assert_array_equal(getattr(t, a).numpy(),
                                      np.asarray(getattr(cams, a)))
    # the port's writer gives the JAX writer's text
    save_act(str(tmp_path / "t.act"), t, start=3, step=2)
    assert (tmp_path / "t.act").read_bytes() == open(path, "rb").read()


def test_act_with_comments_and_odd_principal_point(tmp_path):
    text = ("# header\n\n<intrinsic parameter>\n500 510 319.5 239.5\n"
            "start:0\nstep:1\nend:1\n<Camera Track>\n"
            "----\nframe0\n1 0 0 0.5\n0 1 0 0\n0 0 1 2\n0 0 0 1\n----\n"
            "----\nframe1\n0 0 1 0\n0 1 0 0.25\n-1 0 0 1\n0 0 0 1\n----\n")
    p = tmp_path / "a.act"
    p.write_text(text)
    t = load_act(str(p), device="cpu")
    j = j_load_act(str(p))
    assert (t.width, t.height) == (j.width, j.height) == (640, 480)
    assert len(t) == 2
    for a in ("K", "R", "t"):
        np.testing.assert_array_equal(getattr(t, a).numpy(),
                                      np.asarray(getattr(j, a)))


def test_rawdepth_matches_jax(tmp_path):
    d = np.random.default_rng(0).uniform(0, 1, (H, W)).astype(np.float32)
    traw.save_depth_raw(str(tmp_path / "t.raw"), d)
    jraw.save_depth_raw(str(tmp_path / "j.raw"), d)
    assert (tmp_path / "t.raw").read_bytes() == \
        (tmp_path / "j.raw").read_bytes()
    np.testing.assert_array_equal(
        traw.load_depth_raw(str(tmp_path / "t.raw"), W, H), d)
    with pytest.raises(ValueError, match="expected"):
        traw.load_depth_raw(str(tmp_path / "t.raw"), W + 1, H)
    d[:10] = 0
    np.testing.assert_array_equal(traw.depth_to_image(d),
                                  jraw.depth_to_image(d))


@pytest.mark.parametrize("use_check", [False, True])
def test_jax_dir_loads_in_the_port(tmp_path, jseqs, use_check):
    d = str(tmp_path / "s")
    jing.save_sequence_dir(d, jseqs[0])
    if use_check:
        # the consistency-filtered set the reference swaps in: DATA/CHECK
        os.makedirs(os.path.join(d, "DATA", "CHECK"))
        for i in range(N):
            jraw.save_depth_raw(os.path.join(d, "DATA", "CHECK",
                                             f"_depth{i}.raw"),
                                np.asarray(jseqs[1].disparity[i]))
    t = ting.load_sequence_dir(d, StitchConfig(), use_check, device="cpu")
    j = jing.load_sequence_dir(d, JConfig(), use_check)
    _assert_seq_equal(t, j)
    want = jseqs[1] if use_check else jseqs[0]
    np.testing.assert_array_equal(t.disparity.numpy(),
                                  np.asarray(want.disparity))


def test_port_dir_loads_in_jax_with_the_same_files(tmp_path, jseqs):
    tseq = _port_seq(jseqs[0])
    ting.save_sequence_dir(str(tmp_path / "t"), tseq)
    jing.save_sequence_dir(str(tmp_path / "j"), jseqs[0])
    names = sorted(os.listdir(tmp_path / "t")) + sorted(
        os.listdir(tmp_path / "t" / "DATA"))
    assert names == sorted(os.listdir(tmp_path / "j")) + sorted(
        os.listdir(tmp_path / "j" / "DATA"))
    for rel in ("cameras.act", "00000.jpg", "00002.jpg",
                os.path.join("DATA", "_depth1.raw")):
        assert (tmp_path / "t" / rel).read_bytes() == \
            (tmp_path / "j" / rel).read_bytes(), rel
    j = jing.load_sequence_dir(str(tmp_path / "t"), JConfig())
    t = ting.load_sequence_dir(str(tmp_path / "t"), StitchConfig(),
                               device="cpu")
    _assert_seq_equal(t, j)
    np.testing.assert_array_equal(np.asarray(j.disparity),
                                  tseq.disparity.numpy())
    # jpeg is lossy: photometrics close, not exact (as tests/test_ingest.py)
    assert np.abs(t.gray.numpy() - tseq.gray.numpy()).mean() < 4.0


@pytest.mark.parametrize("name", ["{:05d}.png", "{}.jpg", None])
def test_frame_name_candidates_and_depth_only(tmp_path, jseqs, name):
    d = str(tmp_path / "s")
    jing.save_sequence_dir(d, jseqs[0])
    for i in range(N):
        src = os.path.join(d, f"{i:05d}.jpg")
        if name is None:
            os.remove(src)          # depth-only: disparity as photometrics
        else:
            from PIL import Image
            Image.open(src).save(os.path.join(d, name.format(i)))
            os.remove(src)
    t = ting.load_sequence_dir(d, StitchConfig(), device="cpu")
    j = jing.load_sequence_dir(d, JConfig())
    _assert_seq_equal(t, j)
    g = t.gray.numpy()
    assert g.max() <= 255.0 and g.max() > 10.0


def test_missing_files_raise(tmp_path, jseqs):
    with pytest.raises(FileNotFoundError, match="no .act"):
        ting.load_sequence_dir(str(tmp_path), StitchConfig(),
                               device="cpu")
    d = str(tmp_path / "s")
    jing.save_sequence_dir(d, jseqs[0])
    os.remove(os.path.join(d, "DATA", "_depth2.raw"))
    with pytest.raises(FileNotFoundError, match="missing depth"):
        ting.load_sequence_dir(d, StitchConfig(), device="cpu")


def test_load_sequences_via_legacy_config(tmp_path, jseqs):
    jing.save_sequence_dir(str(tmp_path / "s0"), jseqs[0])
    jing.save_sequence_dir(str(tmp_path / "s1"), jseqs[1])
    (tmp_path / "imgPathList.txt").write_text("./s0/ # first\n" +
                                              str(tmp_path / "s1") + "\n")
    (tmp_path / "config.txt").write_text(
        "ImgPathList ./imgPathList.txt\nViewCount 1\nMinDsp 0.001\n"
        "MaxDsp 10.0\n")
    cfg = load_legacy_config(str(tmp_path / "config.txt"))
    seqs = ting.load_sequences(cfg, str(tmp_path), device="cpu")
    jcfg = j_load_config(str(tmp_path / "config.txt"))
    jseq = jing.load_sequences(jcfg, str(tmp_path))
    assert len(seqs) == len(jseq) == 2
    for t, j in zip(seqs, jseq):
        _assert_seq_equal(t, j)
    assert seqs[0].gray.shape == (N, H, W)
    # the prefetched load equals reading each directory in turn
    serial = [ting.load_sequence_dir(str(tmp_path / d), cfg, device="cpu")
              for d in ("s0", "s1")]
    for a, b in zip(seqs, serial):
        assert torch.equal(a.gray, b.gray)
        assert torch.equal(a.disparity, b.disparity)
        assert torch.equal(a.cams.K, b.cams.K)


def test_prefetch_map_keeps_order_and_raises_in_place():
    assert list(prefetch_map(lambda x: x * x, range(7))) == \
        [x * x for x in range(7)]

    def boom(x):
        if x == 3:
            raise KeyError(x)
        return x
    it = prefetch_map(boom, range(6))
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(KeyError):
        next(it)
