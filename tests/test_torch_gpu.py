"""The hand-written CUDA kernels K1-K3 against their plain PyTorch versions
on the card. Every test here needs an NVIDIA GPU with nvcc and skips
without one. The file imports no jax, so the card runs it without the
JAX package (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: the kernels are built with -fmad=false and follow their plain
versions' operand order, so K1's kept mask and K2's confidence agree on
>= 99.99 % of pixels (equal values where both keep) and K3's z-buffer is
bit-identical (atomicMax of a max is order-free)."""

import numpy as np
import pytest
import torch

from multiviewstitch_tpu_torch.ops import consistency as tc
from multiviewstitch_tpu_torch.ops import point_sampling as tps
from multiviewstitch_tpu_torch.ops import rasterizer as tr
from multiviewstitch_tpu_torch.pipeline.fixtures import (make_scene,
                                                         ring_cameras,
                                                         uv_sphere)
from multiviewstitch_tpu_torch.core.cameras import CameraBatch

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels K1-K3)")
    from multiviewstitch_tpu_torch.kernels import _build
    _build.load()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(cuda):
    sc = make_scene(n_frames=5, width=160, height=120, bumps=0.15,
                    n_lat=64, n_lon=96, arc_deg=60.0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    d = sc.disparity * (1 + 0.01 * torch.randn(sc.disparity.shape,
                                               generator=g, device=cuda))
    return d, sc.cams


def _counted(name, fn):
    from multiviewstitch_tpu_torch import kernels
    before = kernels.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    return out


def test_k1_consistency_matches_plain(scene):
    d, cams = scene
    kw = dict(min_dsp=1e-3, max_dsp=10.0, reproj_err=4)
    got = _counted("consistency", lambda: tc.check_consistency(d, cams, **kw))
    ref = tc.check_consistency_reference(d, cams, **kw)
    assert ((got > 0) == (ref > 0)).float().mean().item() >= 0.9999
    both = (got > 0) & (ref > 0)
    assert torch.equal(got[both], ref[both])
    assert both.sum() > 0.3 * (d > 0).sum()


def test_k2_sampling_votes_match_plain(scene):
    d, cams = scene
    op = tps.sample_oriented_points(d, cams, min_dsp=1e-3, max_dsp=10.0,
                                    sample_radius=2, nbr_num=2)
    n, h, w = d.shape
    pts_s = op.points.reshape(n, len(range(0, h, 2)), len(range(0, w, 2)), 3)
    kw = dict(nbr_num=2, nbr_step=1, min_dsp=1e-3, max_dsp=10.0,
              dsp_err=0.01)
    got = _counted("sampling_votes",
                   lambda: tps.sampling_votes(pts_s, d, cams, **kw))
    ref = tps.sampling_votes_reference(pts_s, d, cams, **kw)
    assert (got == ref).float().mean().item() >= 0.9999
    assert (got > 0).any() and (got < 1).any()


@pytest.mark.parametrize("case", ["sphere", "giant", "border"])
def test_k3_raster_matches_plain(cuda, case):
    if case == "sphere":
        verts, faces = uv_sphere(64, 96, bumps=0.15)
        cams = ring_cameras(4, width=160, img_height=120, arc_deg=60.0,
                            device=cuda)
        h, w = 120, 160
    else:
        if case == "giant":
            verts = np.asarray([[-20, -20, 2.0], [20, -20, 2.0],
                                [20, 20, 2.0], [-20, 20, 2.0]], np.float32)
        else:
            verts = np.asarray([[-1.5, -1.2, 2.0], [0.3, -1.0, 2.2],
                                [-1.2, 0.4, 1.8], [0.5, 0.4, 2.0]],
                               np.float32)
        faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
        h, w, f = 240, 320, 300.0
        K = torch.tensor([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2],
                          [0, 0, 1]], device=cuda)
        cams = CameraBatch(K[None], torch.eye(3, device=cuda)[None],
                           torch.zeros(1, 3, device=cuda), w, h)
    uvz, fi, ok = tr.project_vertices(
        torch.as_tensor(verts, device=cuda),
        torch.as_tensor(faces, device=cuda),
        torch.ones(len(faces), dtype=torch.bool, device=cuda), cams)
    got = _counted("raster", lambda: tr.raster(uvz, fi, ok, height=h,
                                               width=w))
    ref = tr.raster_reference(uvz, fi, ok, height=h, width=w)
    assert torch.equal(got, ref)
    assert (got > 0).any()
    if case == "giant":
        assert torch.allclose(got, torch.full_like(got, 0.5), atol=1e-5)
    if case == "border":
        assert got[0, 0, 0] > 0


def test_wrappers_check_their_inputs(scene):
    from multiviewstitch_tpu_torch import kernels
    d, cams = scene
    with pytest.raises(TypeError):
        kernels.consistency(d.double(), cams.K, cams.R, cams.t, min_dsp=0.0,
                            max_dsp=1.0, reproj_err=4)
    with pytest.raises(ValueError):
        kernels.consistency(d, cams.K[:2], cams.R, cams.t, min_dsp=0.0,
                            max_dsp=1.0, reproj_err=4)
    with pytest.raises(ValueError):
        kernels.consistency(d.transpose(1, 2), cams.K, cams.R, cams.t,
                            min_dsp=0.0, max_dsp=1.0, reproj_err=4)
    with pytest.raises(ValueError):
        kernels.consistency(d, cams.K.cpu(), cams.R, cams.t, min_dsp=0.0,
                            max_dsp=1.0, reproj_err=4)
