"""The port's models/parts and models/template_body (its own copies) against
the JAX package's: the template and posed arrays equal byte for byte, part
files byte-identical, and the 1-NN label transfer equal on >= 99.9 % of
points (the port takes exact differences where JAX expands
|q|^2 - 2 q.r + |r|^2, so a near-tie may go the other way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiviewstitch_tpu.models import parts as JP
from multiviewstitch_tpu.models import template_body as JT
from multiviewstitch_tpu_torch.models import parts as TP
from multiviewstitch_tpu_torch.models import template_body as TT

torch.set_num_threads(2)


def test_part_enum_names_and_colors_equal_jax():
    assert TP.PART_NAMES == JP.PART_NAMES
    assert TP.NUM_PARTS == JP.NUM_PARTS == 16
    for name in JP.PART_NAMES:
        assert getattr(TP, _const(name)) == getattr(JP, _const(name))
    assert np.array_equal(TP.PART_COLORS, JP.PART_COLORS)


def _const(name):
    out = "".join("_" + c if c.isupper() else c for c in name)
    return out.lstrip("_").upper()


@pytest.mark.parametrize("kw", [{}, dict(n_seg=6, n_ring=8)])
def test_make_template_equals_jax(kw):
    for a, b in zip(TT.make_template(**kw), JT.make_template(**kw)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arm,leg", [(18.0, 0.0), (15.0, 5.0), (-30.0, 12.0)])
def test_pose_template_equals_jax(arm, leg):
    v, _, lbl = TT.make_template()
    a = TT.pose_template(v, lbl, arm_angle_deg=arm, leg_spread_deg=leg)
    b = JT.pose_template(v, lbl, arm_angle_deg=arm, leg_spread_deg=leg)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_part_files_byte_identical(tmp_path):
    v, _, lbl = TT.make_template()
    TP.save_parts(str(tmp_path / "t"), lbl)
    JP.save_parts(str(tmp_path / "j"), lbl)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    got = TP.load_parts(str(tmp_path / "j"), len(v))
    assert np.array_equal(got, JP.load_parts(str(tmp_path / "t"), len(v)))
    assert np.array_equal(got, lbl)
    (tmp_path / "joints").write_text("Left=1;2;3\nRight=7; 9\n\njunk\n")
    assert (TP.load_shoulder_joints(str(tmp_path / "joints")) ==
            JP.load_shoulder_joints(str(tmp_path / "joints")))
    TP.visualize_parts(str(tmp_path / "tv.obj"), v[:50], lbl[:50])
    JP.visualize_parts(str(tmp_path / "jv.obj"), v[:50], lbl[:50])
    assert (tmp_path / "tv.obj").read_bytes() == \
        (tmp_path / "jv.obj").read_bytes()


def _scan(kind):
    v, _, lbl = TT.make_template()
    rng = np.random.default_rng(0)
    if kind == "noisy template":
        return v, lbl, (v + 0.005 * rng.normal(size=v.shape)).astype(
            np.float32)
    posed = TT.pose_template(v, lbl, arm_angle_deg=15.0, leg_spread_deg=5.0)
    dense = np.concatenate([posed, 0.5 * (posed[:-1] + posed[1:])])
    return v, lbl, (1.05 * dense + 0.01 * rng.normal(size=dense.shape)
                    ).astype(np.float32)


@pytest.mark.parametrize("kind", ["noisy template", "posed dense scan"])
def test_part_recog_matches_jax(kind):
    v, lbl, scan = _scan(kind)
    want = np.asarray(JP.part_recog(v, lbl, scan, chunk=1024))
    got = TP.part_recog(torch.as_tensor(v), torch.as_tensor(lbl),
                        torch.as_tensor(scan), chunk=1024)
    assert got.dtype == torch.int32 and got.shape == (len(scan),)
    agree = (got.numpy() == want).mean()
    assert agree >= 0.999, agree


def test_nearest_neighbor_indices_exact():
    rng = np.random.default_rng(1)
    ref = rng.normal(size=(500, 3)).astype(np.float32)
    q = ref[[3, 77, 401]] + 1e-4
    got = TP.nearest_neighbor_indices(torch.as_tensor(q),
                                      torch.as_tensor(ref), chunk=2)
    assert got.tolist() == [3, 77, 401]
    assert np.array_equal(
        got.numpy(), JP.nearest_neighbor_indices(jnp.asarray(q), ref))
    assert TP.nearest_neighbor_indices(torch.zeros(0, 3),
                                       torch.as_tensor(ref)).shape == (0,)
