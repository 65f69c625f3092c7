"""K1's plain version (the port's CPU path of check_consistency) against the
JAX package's check_consistency, and the plain gather against the Pallas
banded gather in interpret mode.

Tolerance: the kept masks agree on >= 99.9 % of pixels and the disparity
is exactly equal where both keep. The residue is floor(x+0.5) ties that
the two libraries' float-op orders resolve differently; the tests report
the count."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiviewstitch_tpu.core.cameras import CameraBatch as JCams
from multiviewstitch_tpu.ops.consistency import check_consistency as j_check
from multiviewstitch_tpu.ops.pallas_gather import pallas_gather_banded
from multiviewstitch_tpu.pipeline.fixtures import make_scene as j_make_scene
from multiviewstitch_tpu_torch.interop import cameras_from_numpy
from multiviewstitch_tpu_torch.ops.consistency import (
    check_consistency, check_consistency_reference, consistency_stats,
    gather_px_frames)

torch.set_num_threads(2)

KW = dict(min_dsp=1e-3, max_dsp=10.0, reproj_err=4)


@pytest.fixture(scope="module")
def scene():
    sc = j_make_scene(n_frames=4, width=96, height=72, bumps=0.15,
                      n_lat=32, n_lon=48, arc_deg=45.0)
    c = sc.cams
    return (np.array(sc.disparity), np.array(c.K), np.array(c.R),
            np.array(c.t), c.width, c.height)


def _noisy(disp, seed):
    """Sphere disparity with 2 % multiplicative noise and 3 % dropouts:
    both kept and killed pixels in bulk."""
    rng = np.random.default_rng(seed)
    d = disp * (1.0 + 0.02 * rng.normal(size=disp.shape))
    d[rng.random(disp.shape) < 0.03] = 0.0
    return d.astype(np.float32)


def _compare(disp, K, R, t, w, h, reproj_err=4):
    kw = dict(KW, reproj_err=reproj_err)
    jout = np.asarray(j_check(jnp.asarray(disp), JCams(K, R, t, w, h), **kw))
    tout = check_consistency(torch.as_tensor(disp),
                             cameras_from_numpy(K, R, t, w, h, "cpu"),
                             **kw).numpy()
    jk, tk = jout > 0, tout > 0
    agree = (jk == tk).mean()
    n_diff = int((jk != tk).sum())
    print(f"kept-mask disagreements: {n_diff} of {jk.size} pixels")
    assert agree >= 0.999, (agree, n_diff)
    both = jk & tk
    np.testing.assert_array_equal(tout[both], jout[both])
    return jk, tk


@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax_on_noisy_sphere(scene, seed):
    disp, K, R, t, w, h = scene
    jk, tk = _compare(_noisy(disp, seed), K, R, t, w, h)
    valid = (disp >= 1e-3) & (disp <= 10.0)
    assert 0.2 * valid.sum() < tk.sum() < valid.sum()   # filter did work


def test_matches_jax_on_clean_sphere(scene):
    disp, K, R, t, w, h = scene
    jk, tk = _compare(disp, K, R, t, w, h, reproj_err=1)
    assert tk.sum() > 0.5 * (disp > 0).sum()


def test_matches_jax_on_random_disparity(scene):
    _, K, R, t, w, h = scene
    rng = np.random.default_rng(5)
    disp = rng.uniform(0.0, 0.8, size=(4, h, w)).astype(np.float32)
    _compare(disp, K, R, t, w, h)


def test_single_frame_keeps_valid_and_stats(scene):
    disp, K, R, t, w, h = scene
    d = torch.as_tensor(disp[:1])
    out = check_consistency_reference(d, cameras_from_numpy(
        K[:1], R[:1], t[:1], w, h, "cpu"), **KW)
    assert torch.equal(out, torch.where((d >= 1e-3) & (d <= 10.0), d, 0.0))
    st = consistency_stats(d, out * 0, 1e-3, 10.0)
    assert st["valid_after"] == 0.0 and st["valid_before"] > 0.0


def test_plain_gather_matches_pallas_banded_interpret():
    H, W = 48, 64
    rng = np.random.default_rng(0)
    src = rng.normal(size=(H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    iy = np.clip(yy + 3 + (2 * np.sin(xx / 9.0)).astype(int), 0,
                 H - 1).astype(np.int32)
    ix = np.clip(xx - 5 + (3 * np.cos(yy / 7.0)).astype(int), 0,
                 W - 1).astype(np.int32)
    vals, ok = pallas_gather_banded(jnp.asarray(src), jnp.asarray(iy),
                                    jnp.asarray(ix), window_rows=16,
                                    interpret=True)
    assert np.asarray(ok).all()
    got = gather_px_frames(torch.as_tensor(src)[None],
                           torch.as_tensor(iy)[None].long(),
                           torch.as_tensor(ix)[None].long())[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(vals))


@pytest.mark.parametrize("offsets", [(-2, -1, 1, 2), (-3, 3)])
def test_neighbour_offsets_match_jax_exactly(offsets):
    """The plain version at other neighbour offsets against JAX's
    check_consistency(offsets=...) on tests/test_view_windows.py's ring
    (no rounding ties there): exact. The default offsets are (-1, 1)."""
    from tests.test_torch_parallel import ring_sequence
    disp, K, R, t = ring_sequence()
    n, h, w = disp.shape
    kw = dict(min_dsp=1e-3, max_dsp=10.0, reproj_err=2)
    want = np.asarray(j_check(jnp.asarray(disp), JCams(K, R, t, w, h),
                              offsets=offsets, **kw))
    cams = cameras_from_numpy(K, R, t, w, h, "cpu")
    got = check_consistency(torch.as_tensor(disp), cams, offsets=offsets,
                            **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.01 < (got > 0).mean() < 0.99
    ref = check_consistency_reference(torch.as_tensor(disp), cams, **kw)
    assert torch.equal(ref, check_consistency_reference(
        torch.as_tensor(disp), cams, offsets=(-1, 1), **kw))
