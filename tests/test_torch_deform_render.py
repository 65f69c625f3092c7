"""The port's pipeline/deform_render and the deform / render / pipeline
commands against the JAX package on the same inputs.

Tolerances:
  - deform_stage (two passes) against JAX: max abs gap <= 1e-3 and mean
    <= 1e-4 on the 1.8 m template, the fit RMS to the scan within 5 % of
    JAX's. Measured: 1.3e-5 max, 4.3e-7 mean. The two are held on the
    untied input (the demo's recipe with the arms at 45 degrees, template
    and scan moved by a seeded 0.1 mm jitter) with the port's tie bounds
    set to zero, so both make the same discrete choices. The demo scan
    itself cannot be used: JAX's fit of it moves by decimetres under
    one-ulp scan noise (test_jax_deform_of_the_demo_scan_is_chaotic),
    while the port's, whose discrete choices order near-ties by index,
    moves by <= 1e-4 (measured 6.9e-6-8.1e-6 on seeds 0-2).
  - the same two ARAP passes from the JAX package's rigid alignment of
    the demo scan, with JAX's control set and the tie bounds at zero:
    within 1e-3 (measured 5.0e-4).
  - render_stage: coverage equal on >= 99.9 % of pixels, disparities
    within 1e-5 relative (the XLA render is not bit-exact), the coverage
    metrics within 1e-3, refined maps within 1e-4 of their range.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiviewstitch_tpu.models.template_body as j_template_body
import multiviewstitch_tpu_torch.models.template_body as t_template_body
from multiviewstitch_tpu.cli import main as j_main
from multiviewstitch_tpu.core.transforms import Similarity as JSim
from multiviewstitch_tpu.models.template_body import make_template
from multiviewstitch_tpu.ops.mesh_normals import vertex_normals as j_normals
from multiviewstitch_tpu.pipeline.deform_render import (
    deform_stage as j_deform_stage, render_stage as j_render_stage)
from multiviewstitch_tpu.pipeline.fixtures import ring_cameras as j_ring
from multiviewstitch_tpu.solvers import alignment as JA
from multiviewstitch_tpu.solvers.deformation import Deformer as JDeformer
from multiviewstitch_tpu_torch.cli import VIEW_RAY, demo_scan, main
from multiviewstitch_tpu_torch.interop import (cameras_from_numpy,
                                               mesh_from_numpy,
                                               similarity_from_numpy)
from multiviewstitch_tpu_torch.io.meshio import read_obj, write_obj
from multiviewstitch_tpu_torch.io.rawdepth import depth_to_image, load_depth_raw
from multiviewstitch_tpu_torch.pipeline.deform_render import (depth_images,
                                                              deform_stage,
                                                              render_stage)
from multiviewstitch_tpu_torch.solvers import alignment as TA
from multiviewstitch_tpu_torch.solvers import deformation as TD
from multiviewstitch_tpu_torch.solvers.deformation import Deformer
from test_torch_deformation import _ulp_noise

torch.set_num_threads(2)

GAP_MAX, GAP_MEAN = 1e-3, 1e-4


def _rms_to(p, q):
    d = [((c[:, None] - q[None]) ** 2).sum(-1).min(1)
         for c in np.array_split(p, max(1, len(p) // 1024))]
    return float(np.sqrt(np.concatenate(d).mean()))


def _check_deform_gap(port_v, jax_v, scan_v):
    gap = np.abs(port_v - jax_v)
    print(f"deform gap max {gap.max():.5f} mean {gap.mean():.6f}")
    assert gap.max() <= GAP_MAX and gap.mean() <= GAP_MEAN
    assert abs(_rms_to(port_v, scan_v) - _rms_to(jax_v, scan_v)) <= \
        0.05 * _rms_to(jax_v, scan_v)


@pytest.fixture(scope="module")
def demo():
    tv, tf, tl = make_template()
    sv, sf = demo_scan()
    return tv, tf, tl, sv, sf


@pytest.fixture(scope="module")
def untied():
    """The demo's recipe (the template posed, scaled by 1.1 and moved) with
    the arms at 45 degrees, template and scan moved by a seeded 0.1 mm
    jitter: no two neighbour distances tie and every limb keeps its far
    label (on the demo scan one leg has no shank label, and there the
    reference's anchor follows the eigen solver's sign)."""
    tv, tf, tl = make_template()
    posed = t_template_body.pose_template(tv, tl, arm_angle_deg=45.0,
                                          leg_spread_deg=5.0)
    sv = 1.1 * posed + np.array([0.15, 0.0, -0.05])
    rng = np.random.default_rng(0)
    tv = (tv + rng.normal(scale=1e-4, size=tv.shape)).astype(np.float32)
    sv = (sv + rng.normal(scale=1e-4, size=sv.shape)).astype(np.float32)
    return tv, tf, tl, sv, tf


def _jax_choices(monkeypatch):
    """The port's tie bounds at zero: its control set, k-NN order, limb
    ends, candidate ranking, facing test and sliver normals then make the
    JAX package's exact comparisons."""
    monkeypatch.setattr(TD, "TIE_REL", 0.0)
    monkeypatch.setattr(TA, "TIE_REL", 0.0)
    monkeypatch.setattr(TD, "FACING_MIN", 0.0)


def _port_deform(tv, tf, tl, sv, sf, **kw):
    return deform_stage(mesh_from_numpy(tv, tf, tl, device="cpu"),
                        mesh_from_numpy(sv, sf, device="cpu"), VIEW_RAY,
                        deform_passes=2, **kw)


def test_deform_stage_on_the_demo_scan_matches_jax(demo, untied, tmp_path,
                                                    monkeypatch):
    """On the demo scan: the stages, the result and deform.obj, and the fit
    RMS within 5 % of JAX's; on the untied input with the same discrete
    choices: within GAP_MAX / GAP_MEAN of JAX."""
    tv, tf, tl, sv, sf = demo
    names = []

    def stage(name, fn):
        names.append(name)
        return fn()
    got = _port_deform(tv, tf, tl, sv, sf, out_obj=str(tmp_path / "d.obj"),
                       stage=stage)
    assert names == ["deform_align_s", "deform_pass0_s", "deform_pass1_s"]
    assert got.vertices.shape == (len(tv), 3)
    assert torch.equal(got.faces, torch.as_tensor(tf, dtype=torch.int64))
    want = j_deform_stage(tv, tf, tl, sv, sf, VIEW_RAY, deform_passes=2)
    fit, j_fit = (_rms_to(v, sv) for v in (got.vertices.numpy(),
                                            np.asarray(want.vertices)))
    print(f"demo scan: fit RMS {fit:.5f}, JAX {j_fit:.5f}")
    assert abs(fit - j_fit) <= 0.05 * j_fit
    v, n, f = read_obj(str(tmp_path / "d.obj"))
    assert np.array_equal(f, tf) and len(v) == len(n) == len(tv)
    np.testing.assert_allclose(v, got.vertices.numpy(), atol=1e-6)

    _jax_choices(monkeypatch)
    tv, tf, tl, sv, sf = untied
    want = j_deform_stage(tv, tf, tl, sv, sf, VIEW_RAY, deform_passes=2)
    _check_deform_gap(_port_deform(tv, tf, tl, sv, sf).vertices.numpy(),
                      np.asarray(want.vertices), sv)


def test_jax_deform_of_the_demo_scan_is_chaotic(demo):
    """Why the port is held to JAX on the untied input: JAX's fit of the
    demo scan moves by decimetres when each scan coordinate moves by one
    float32 ulp (its control set and a leg's anchor follow the noise).
    Measured on seeds 0-2: 0.908, 0.088, 0.841."""
    tv, tf, tl, sv, sf = demo
    base = np.asarray(j_deform_stage(tv, tf, tl, sv, sf, VIEW_RAY,
                                     deform_passes=2).vertices)
    gaps = [np.abs(np.asarray(j_deform_stage(
        tv, tf, tl, _ulp_noise(sv, seed), sf, VIEW_RAY,
        deform_passes=2).vertices) - base).max() for seed in range(3)]
    print("JAX under one-ulp scan noise: max abs " +
          ", ".join(f"{g:.3g}" for g in gaps))
    assert max(gaps) > 0.1


@pytest.mark.parametrize("seed", range(3))
def test_deform_stage_is_stable_under_one_ulp_scan_noise(demo, seed):
    """The port's fit of the demo scan under the same noise: its discrete
    choices order near-ties by index, so it moves by <= 1e-4 (measured
    6.9e-6-8.1e-6); this is what holds the card to the CPU."""
    tv, tf, tl, sv, sf = demo
    base = _port_deform(tv, tf, tl, sv, sf).vertices.numpy()
    got = _port_deform(tv, tf, tl, _ulp_noise(sv, seed), sf).vertices.numpy()
    gap = np.abs(got - base).max()
    print(f"port under one-ulp scan noise (seed {seed}): max abs {gap:.3g}")
    assert gap <= 1e-4


def test_deformer_passes_from_the_jax_alignment_match_jax(demo, monkeypatch):
    """Two passes from JAX's rigid alignment of the demo scan with JAX's
    control set and the same discrete choices."""
    _jax_choices(monkeypatch)
    tv, tf, tl, sv, sf = demo
    sn = np.asarray(j_normals(jnp.asarray(sv), jnp.asarray(sf)))
    tn = np.asarray(j_normals(jnp.asarray(tv), jnp.asarray(tf)))
    res = JA.align(tv, tn, tl, sv, sn, sf, VIEW_RAY)
    tgt = res.tgt.astype(np.float32)
    tgt_n = np.asarray(j_normals(jnp.asarray(tgt), jnp.asarray(res.t_faces)))
    src = res.src.astype(np.float32)
    jd = JDeformer(src, tf, res.s_normals)
    td = Deformer(torch.as_tensor(src), torch.as_tensor(tf, dtype=torch.int64),
                  torch.as_tensor(res.s_normals, dtype=torch.float32),
                  sample_idx=jd.sample_idx)
    for _ in range(2):
        want = jd.deform(tgt, tgt_n)
        got = td.deform(torch.as_tensor(tgt), torch.as_tensor(tgt_n))
    gap = np.abs(got.numpy() - want).max()
    print(f"two passes from one alignment: gap {gap:.3g}")
    assert gap <= 1e-3
    assert np.abs(want - src).max() > 0.01


def _render_case():
    tv, tf, tl = make_template()
    center = tv.mean(0)
    cams = j_ring(4, radius=2.6, width=160, img_height=120, arc_deg=60.0,
                  look_at=tuple(center.tolist()), height=float(center[1]))
    yaw = np.radians(9.0)
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    s, t = np.float32(1.12), np.array([0.12, -0.06, 0.1], np.float32)
    return tv, tf, cams, (s, R, t)


def _compare_renders(got, want):
    cov = ((got > 0) == (want > 0)).mean()
    both = (got > 0) & (want > 0)
    rel = (np.abs(got - want)[both] / want[both]).max()
    print(f"render coverage agreement {cov:.6f}, max rel {rel:.3g}")
    assert cov >= 0.999 and rel <= 1e-5 and both.sum() > 1000


def test_render_stage_matches_jax(tmp_path):
    tv, tf, jcams, (s, R, t) = _render_case()
    jT = JSim(jnp.asarray(s), jnp.asarray(R), jnp.asarray(t))
    rng = np.random.default_rng(0)
    base = np.asarray(j_render_stage(tv, tf, [jT], [jcams])[0])
    meas = (base * (1 + 0.01 * rng.normal(size=base.shape))).astype(
        np.float32)
    meas[:, 50:70, 70:90] = 0.0
    outs = {}
    for name, kw in (("plain", {}), ("refined", dict(refine=True))):
        jm, tm = {}, {}
        want = np.asarray(j_render_stage(
            tv, tf, [jT], [jcams], measured_disparity=[meas], metrics=jm,
            **kw)[0])
        tcams = cameras_from_numpy(np.asarray(jcams.K), np.asarray(jcams.R),
                                   np.asarray(jcams.t), jcams.width,
                                   jcams.height, "cpu")
        got = render_stage(
            torch.as_tensor(tv), torch.as_tensor(tf, dtype=torch.int64),
            [similarity_from_numpy(s, R, t, "cpu")], [tcams],
            out_dirs=[str(tmp_path / name)],
            measured_disparity=[torch.as_tensor(meas)], metrics=tm,
            **kw)[0].numpy()
        assert set(tm) == set(jm) == {"render_coverage", "measured_overlap"}
        for k in jm:
            assert abs(tm[k] - jm[k]) <= 1e-3, (k, tm, jm)
        outs[name] = got, want
    _compare_renders(*outs["plain"])
    got, want = outs["refined"]
    assert np.abs(got - want).max() <= 1e-4 * float(want.max() - want.min())
    rdir = tmp_path / "refined" / "DATA" / "Render"
    for i in range(4):
        raw = load_depth_raw(str(rdir / f"_depth{i}.raw"), 160, 120)
        assert np.array_equal(raw, got[i])
        assert (rdir / f"_depth{i}.jpg").stat().st_size > 0


def test_depth_images_are_depth_to_image_frame_by_frame():
    rng = np.random.default_rng(3)
    d = np.where(rng.random((5, 12, 10)) < 0.4,
                 rng.random((5, 12, 10)) * 3, 0).astype(np.float32)
    d[1] = 0.0                               # no valid pixel
    d[2] = np.where(d[2] > 0, 0.7, 0.0)      # one value: hi == lo
    d[3] = 0.0
    d[3, 4, 5] = 1.5                         # a single valid pixel
    d[4, 0, 0] = -2.0                        # negative: not valid
    got = depth_images(torch.as_tensor(d))
    assert got.dtype == torch.uint8 and got.shape == d.shape
    for i in range(d.shape[0]):
        np.testing.assert_array_equal(got[i].numpy(), depth_to_image(d[i]))


def test_render_stage_writes_the_frame_by_frame_files(tmp_path):
    """The threaded writer leaves each _depth<i>.raw / .jpg as writing
    the frames one by one through ``depth_to_image`` and PIL does."""
    import io

    from PIL import Image
    tv, tf, jcams, (s, R, t) = _render_case()
    tcams = cameras_from_numpy(np.asarray(jcams.K), np.asarray(jcams.R),
                               np.asarray(jcams.t), jcams.width,
                               jcams.height, "cpu")
    got = render_stage(
        torch.as_tensor(tv), torch.as_tensor(tf, dtype=torch.int64),
        [similarity_from_numpy(s, R, t, "cpu")], [tcams],
        out_dirs=[str(tmp_path)])[0].numpy()
    rdir = tmp_path / "DATA" / "Render"
    assert sorted(os.listdir(rdir)) == sorted(
        f"_depth{i}.{e}" for i in range(4) for e in ("raw", "jpg"))
    for i in range(4):
        assert (rdir / f"_depth{i}.raw").read_bytes() == \
            got[i].astype(np.float32).tobytes()
        buf = io.BytesIO()
        Image.fromarray(depth_to_image(got[i])).save(buf, format="JPEG")
        assert (rdir / f"_depth{i}.jpg").read_bytes() == buf.getvalue()


@pytest.fixture(scope="module")
def jax_cli_workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("jax_cli")
    assert j_main(["deform", "--demo", "--workdir", str(wd)]) == 0
    assert j_main(["render", "--workdir", str(wd)]) == 0
    return wd


def test_cli_deform_demo_matches_jax_cli(jax_cli_workdir, untied, tmp_path,
                                        monkeypatch):
    """deform --demo: the stages, and the fit RMS within 5 % of the JAX
    CLI's; then both CLIs' deform of the untied scan (Result/Model.obj)
    with the untied template and the same discrete choices: within
    GAP_MAX / GAP_MEAN."""
    stages = []
    assert main(["deform", "--demo", "--device", "cpu", "--workdir",
                 str(tmp_path)], stage=lambda n, fn: stages.append(n) or
                fn()) == 0
    assert stages == ["deform_s", "deform_align_s", "deform_pass0_s",
                      "deform_pass1_s"]
    jv, _, jf = read_obj(str(jax_cli_workdir / "Result" / "deform.obj"))
    tv, tn, tf = read_obj(str(tmp_path / "Result" / "deform.obj"))
    assert np.array_equal(tf, jf) and len(tn) == len(tv)
    sv = demo_scan()[0]
    assert abs(_rms_to(tv, sv) - _rms_to(jv, sv)) <= 0.05 * _rms_to(jv, sv)

    _jax_choices(monkeypatch)
    utv, utf, utl, usv, _ = untied
    for mod in (j_template_body, t_template_body):
        monkeypatch.setattr(mod, "make_template", lambda: (utv, utf, utl))
    wds = [tmp_path / "jax", tmp_path / "port"]
    for wd in wds:
        os.makedirs(wd / "Result")
        write_obj(str(wd / "Result" / "Model.obj"), usv, None, utf)
    assert j_main(["deform", "--workdir", str(wds[0])]) == 0
    assert main(["deform", "--device", "cpu", "--workdir", str(wds[1])]) == 0
    jv, _, _ = read_obj(str(wds[0] / "Result" / "deform.obj"))
    tv, _, _ = read_obj(str(wds[1] / "Result" / "deform.obj"))
    _check_deform_gap(tv, jv, read_obj(str(wds[0] / "Result" /
                                           "Model.obj"))[0])


def test_cli_render_matches_jax_cli(jax_cli_workdir, tmp_path, capsys):
    """The port renders the JAX CLI's deform.obj: the same demo ring, the
    same rasters."""
    os.makedirs(tmp_path / "Result")
    shutil.copy(jax_cli_workdir / "Result" / "deform.obj",
                tmp_path / "Result" / "deform.obj")
    stages = []
    assert main(["render", "--device", "cpu", "--workdir", str(tmp_path)],
                stage=lambda n, fn: stages.append(n) or fn()) == 0
    assert stages == ["render_s"]
    assert "coverage" in capsys.readouterr().out
    got = np.stack([load_depth_raw(
        str(tmp_path / "DATA" / "Render" / f"_depth{i}.raw"), 160, 120)
        for i in range(4)])
    want = np.stack([load_depth_raw(
        str(jax_cli_workdir / "DATA" / "Render" / f"_depth{i}.raw"), 160,
        120) for i in range(4)])
    _compare_renders(got, want)
    assert not (tmp_path / "DATA" / "Render" / "_depth4.raw").exists()


def test_cli_render_needs_deform_obj(tmp_path, capsys):
    assert main(["render", "--device", "cpu", "--workdir", str(tmp_path)]) \
        == 2
    assert "deform.obj not found" in capsys.readouterr().out


def test_cli_pipeline_demo_writes_every_output(tmp_path):
    stages = []
    rc = main(["pipeline", "--demo", "--device", "cpu", "--grid", "48",
               "--workdir", str(tmp_path)],
              stage=lambda n, fn: stages.append(n) or fn())
    assert rc == 0
    assert stages == ["prep_s", "sweep_solve_s", "fuse_s", "tsdf_s",
                      "trim_write_s", "deform_s", "deform_align_s",
                      "deform_pass0_s", "deform_pass1_s", "render_s"]
    res = tmp_path / "Result"
    for f in ("SRT.txt", "PSR.npts", "Model.obj", "deform.obj"):
        assert (res / f).stat().st_size > 0, f
    v, n, f = read_obj(str(res / "deform.obj"))
    assert len(v) == len(make_template()[0]) == len(n) and np.isfinite(v).all()
    rdir = tmp_path / "DATA" / "Render"
    assert sorted(os.listdir(rdir)) == sorted(
        f"_depth{i}.{e}" for i in range(4) for e in ("raw", "jpg"))
    d = np.stack([load_depth_raw(str(rdir / f"_depth{i}.raw"), 160, 120)
                  for i in range(4)])
    assert (d > 0).mean() > 0.02 and np.isfinite(d).all()
