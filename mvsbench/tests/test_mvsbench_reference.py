"""The plain reference against the port's plain path at a tiny size on
the CPU, and its readers against the port's writers."""

import os

import numpy as np
import pytest
import torch

from multiviewstitch_tpu_torch.core.cameras import CameraBatch
from multiviewstitch_tpu_torch.core.transforms import Similarity
from multiviewstitch_tpu_torch.io.meshio import write_npts, write_obj
from multiviewstitch_tpu_torch.io.srt import save_srt
from multiviewstitch_tpu_torch.ops.consistency import (
    check_consistency_reference)
from multiviewstitch_tpu_torch.ops.point_sampling import (
    sample_oriented_points_reference)
from multiviewstitch_tpu_torch.ops.rasterizer import render_sequence
from multiviewstitch_tpu_torch.pipeline.align_seq import (AlignResult,
                                                          Sequence,
                                                          fuse_sequences)
from multiviewstitch_tpu_torch.solvers.unionfind import (
    retain_largest_component)
from mvsbench import reference as ref
from mvsbench.geometry import Mat, Sim, tf32
from mvsbench.judge import cloud_numbers, render_numbers
from mvsbench.scenes import bumpy_sphere

CPU = torch.device("cpu")
TRAFFIC = dict(sequences=2, frames=5, width=96, height=72, focal=78.75,
               arc_deg=45.0, arc_offset_deg=1.5, turn_deg=360.0,
               cam_radius=2.0, radius=0.5, bumps=0.15, n_lat=24, n_lon=36,
               scale=1.3, yaw_deg=14.3, translation=[0.15, -0.1, 0.2],
               noise=1.0, depth_noise=True)
CFG = dict(min_dsp=1e-3, max_dsp=10.0, reproj_err=4, sample_radius=2,
           nbr_frm_num=2, nbr_frm_step=1, dsp_err=0.01, conf_min=0.6)


@pytest.fixture(scope="module")
def scene():
    return bumpy_sphere.generate(TRAFFIC, 2 ** 31 + 3, CPU)


def _port_cams(c):
    return CameraBatch(c.K, c.R, c.t, c.width, c.height)


def test_consistency_and_samples_match_the_port(scene):
    f = scene.sequences[0]
    mine = ref.consistency(f.disparity, f.cams, Mat(), min_dsp=1e-3,
                           max_dsp=10.0, reproj_err=4)
    port = check_consistency_reference(f.disparity, _port_cams(f.cams),
                                       min_dsp=1e-3, max_dsp=10.0,
                                       reproj_err=4)
    assert (mine > 0).sum() > 1000
    assert ((mine > 0) != (port > 0)).float().mean() < 1e-3
    p, n, keep = ref.oriented_samples(
        port, f.cams, Mat(), min_dsp=1e-3, max_dsp=10.0, sample_radius=2,
        nbr_num=2, nbr_step=1, dsp_err=0.01, conf_min=0.6)
    op = sample_oriented_points_reference(
        port, _port_cams(f.cams), min_dsp=1e-3, max_dsp=10.0,
        sample_radius=2, nbr_num=2, nbr_step=1, dsp_err=0.01, conf_min=0.6)
    assert (keep != op.valid).float().mean() < 1e-3
    both = keep & op.valid
    torch.testing.assert_close(p[both], op.points[both], rtol=0, atol=1e-5)
    torch.testing.assert_close(n[both], op.normals[both], rtol=0, atol=1e-4)


def test_fuse_matches_the_ports_fuse(scene):
    srt = [g for g in scene.gt]
    sims = [Similarity(torch.tensor(T.s, dtype=torch.float32),
                       torch.as_tensor(T.R, dtype=torch.float32),
                       torch.as_tensor(T.t, dtype=torch.float32))
            for T in srt]
    seqs = [Sequence(f.gray, f.disparity, _port_cams(f.cams))
            for f in scene.sequences]
    cfg = type("C", (), {k: v for k, v in CFG.items()})
    pts, nrm = fuse_sequences(seqs, AlignResult(sims, [], []), cfg)
    rp, rn = ref.fuse([(f.disparity, f.cams) for f in scene.sequences],
                      [Sim(float(np.float32(T.s)), T.R.astype(np.float32)
                           .astype(np.float64), T.t.astype(np.float32)
                           .astype(np.float64)) for T in srt], CFG, Mat())
    nums = cloud_numbers(pts, nrm, rp, rn)
    assert nums["cloud_gap"] < 1e-5 and nums["cloud_count_gap"] < 1e-3
    assert nums["normal_gap"] < 1e-4
    # the control: the same reference with TF32 operands fails all three
    lp, ln = ref.fuse([(f.disparity, f.cams) for f in scene.sequences], srt,
                      CFG, Mat("tf32"))
    low = cloud_numbers(lp, ln, rp, rn)
    assert low["cloud_gap"] > 100 * nums["cloud_gap"]


def test_render_matches_the_ports_plain_raster(scene):
    f = scene.sequences[0]
    v = scene.truth_vertices
    faces = scene.truth_faces
    srt = [Sim(1.0, np.eye(3), np.zeros(3))]
    mine = ref.render(v, faces, srt, [f.cams], Mat())[0]
    port = render_sequence(torch.as_tensor(v), torch.as_tensor(faces),
                           torch.ones(len(faces), dtype=torch.bool),
                           _port_cams(f.cams), height=f.cams.height,
                           width=f.cams.width)
    nums = render_numbers([port.numpy()], [mine.numpy()])
    assert nums["render_mismatch"] < 1e-3 and nums["render_gap"] < 1e-5
    low = ref.render(v, faces, srt, [f.cams], Mat("tf32"))[0]
    assert render_numbers([low.numpy()], [mine.numpy()])["render_gap"] > \
        100 * max(nums["render_gap"], 1e-7)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.1415927])
    y = tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0           # a tie rounds to even
    assert y[2] == 1.0 + 2 ** -9
    assert abs(float(y[3]) + 3.1415927) < 2 ** -9 * 4


def test_surface_distance_is_exact():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2], [1, 3, 2]])
    pts = np.array([[0.2, 0.2, 0.5], [2.0, 0.5, 0.0], [-1, -1, 0],
                    [0.5, 0.5, -0.25]], np.float32)
    d = ref.surface_distance(pts, verts, faces, CPU)
    np.testing.assert_allclose(d, [0.5, 1.0, np.sqrt(2), 0.25], atol=1e-7)


def test_components_match_the_ports_trim(scene):
    v = scene.truth_vertices
    f = scene.truth_faces.astype(np.int64)
    assert ref.components(len(v), f) == 1
    two = np.concatenate([v, v + 5.0])
    ff = np.concatenate([f, f + len(v)])
    assert ref.components(len(two), ff) == 2
    kv, kf, _ = retain_largest_component(two, ff)
    assert ref.components(len(kv), np.asarray(kf, np.int64)) == 1


def test_readers_read_the_ports_files(tmp_path, scene):
    v, f = scene.truth_vertices, scene.truth_faces
    n = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (len(v), 1))
    for normals in (None, n):
        p = os.path.join(tmp_path, "m.obj")
        write_obj(p, v, normals, f)
        rv, rf = ref.read_obj(p)
        np.testing.assert_array_equal(rv, v)
        np.testing.assert_array_equal(rf, f)
    p = os.path.join(tmp_path, "p.npts")
    write_npts(p, v, n)
    rp, rn = ref.read_npts(p)
    np.testing.assert_allclose(rp, v, rtol=1e-7)
    p = os.path.join(tmp_path, "SRT.txt")
    T = scene.gt[0]
    save_srt(p, [Similarity(torch.tensor(T.s, dtype=torch.float32),
                            torch.as_tensor(T.R, dtype=torch.float32),
                            torch.as_tensor(T.t, dtype=torch.float32))])
    (r,) = ref.read_srt(p)
    assert r.s == pytest.approx(T.s, rel=1e-7)
    np.testing.assert_allclose(r.R, T.R, atol=1e-7)
