"""The hand-written CUDA kernels K1-K4 against their plain PyTorch versions
on the card (K1 also at other neighbour offsets), the plain-PyTorch
stages around them (deform, depth refine, bundle adjustment, the pose
graph, the refined demo align) on the card against the CPU, and the
multi-device layer over one NCCL rank (the windowed filter, sharded BA). Every test here needs an NVIDIA GPU with nvcc and skips
without one. The file imports no jax, so the card runs it without the
JAX package (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: the kernels are built with -fmad=false and follow their plain
versions' operand order, so K1's output and K2's points are bit-identical,
K2's confidences and keep mask agree on >= 99.99 % of samples and its
normals lie within 1e-6 on >= 99.99 % of the samples both keep (PyTorch's
cross, norm and sum kernels may contract or reorder; an edge-on normal may
flip), K3's z-buffer is bit-identical (a max is order-free, whatever
order a tile's bin holds), and so is every K4 output (the Poisson field's
stencils, in the plain code's operation order). Every test checks the
kernel's launch count."""

import numpy as np
import pytest
import torch

from multiviewstitch_tpu_torch import kernels
from multiviewstitch_tpu_torch.ops import consistency as tc
from multiviewstitch_tpu_torch.ops import point_sampling as tps
from multiviewstitch_tpu_torch.ops import rasterizer as tr
from multiviewstitch_tpu_torch.pipeline.fixtures import (make_scene,
                                                         ring_cameras,
                                                         uv_sphere)
from multiviewstitch_tpu_torch.core.cameras import CameraBatch
from multiviewstitch_tpu_torch.utils import profiling
from poisson_weld_oracle import slabs_numpy

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels K1-K4)")
    from multiviewstitch_tpu_torch.kernels import _build
    _build.load()
    return torch.device("cuda")


def _noisy(sc, cuda, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return sc.disparity * (1 + 0.01 * torch.randn(sc.disparity.shape,
                                                  generator=g, device=cuda))


@pytest.fixture(scope="module")
def scene(cuda):
    sc = make_scene(n_frames=5, width=160, height=120, bumps=0.15,
                    n_lat=64, n_lon=96, arc_deg=60.0, device=cuda)
    return _noisy(sc, cuda), sc.cams


def _counted(name, fn):
    before = kernels.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    return out


K1_KW = dict(min_dsp=1e-3, max_dsp=10.0, reproj_err=4)


def _k1_matches_plain(d, cams):
    got = _counted("consistency",
                   lambda: tc.check_consistency(d, cams, **K1_KW))
    ref = tc.check_consistency_reference(d, cams, **K1_KW)
    assert torch.equal(got, ref)
    return got


def test_k1_consistency_matches_plain(scene):
    d, cams = scene
    got = _k1_matches_plain(d, cams)
    assert (got > 0).sum() > 0.3 * (d > 0).sum()


@pytest.mark.parametrize("frames,width,height", [
    (1, 160, 120), (2, 160, 120), (2, 157, 61), (64, 96, 72), (64, 94, 45)])
def test_k1_frames_and_widths_match_plain(cuda, frames, width, height):
    # widths 157 and 94 are not multiples of 4 (the scalar path), 61 and
    # 45 rows not multiples of the 8-row tile
    sc = make_scene(n_frames=frames, width=width, height=height, bumps=0.15,
                    n_lat=32, n_lon=48, arc_deg=60.0, device=cuda)
    d = _noisy(sc, cuda)
    got = _k1_matches_plain(d, sc.cams)
    assert (got > 0).any()
    if frames == 1:                     # no neighbour: every valid pixel
        assert torch.equal(got > 0, d > 0)


def test_k1_unaligned_rows_take_the_scalar_path(scene):
    d, cams = scene
    buf = torch.empty(d.numel() + 1, dtype=d.dtype, device=d.device)
    shifted = buf[1:].view(d.shape)     # contiguous, 4 bytes off 16
    shifted.copy_(d)
    assert shifted.data_ptr() % 16 == 4
    assert torch.equal(_k1_matches_plain(shifted, cams),
                       _k1_matches_plain(d, cams))


@pytest.mark.parametrize("offsets", [(-2, -1, 1, 2), (-3, 3), (1,),
                                     (-16, 16)])
def test_k1_neighbour_offsets_match_plain(cuda, offsets):
    sc = make_scene(n_frames=12, width=96, height=72, bumps=0.15,
                    n_lat=32, n_lon=48, arc_deg=60.0, device=cuda)
    d = _noisy(sc, cuda)
    kw = dict(K1_KW, offsets=offsets)
    got = _counted("consistency",
                   lambda: tc.check_consistency(d, sc.cams, **kw))
    assert torch.equal(got, tc.check_consistency_reference(d, sc.cams, **kw))
    with pytest.raises(ValueError, match="offsets"):
        tc.check_consistency(d, sc.cams, offsets=(17,), **K1_KW)


@pytest.fixture(scope="module")
def nccl_mesh(cuda):
    from multiviewstitch_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh()
    yield mesh
    mesh.close()


def test_mesh_collectives_on_one_nccl_rank(cuda, nccl_mesh):
    """all_reduce and all_gather (a bool tensor sent as bytes) run on NCCL
    at world size 1 and return their input."""
    from multiviewstitch_tpu_torch.parallel.mesh import (all_reduce_sum,
                                                         gather_along)
    x = torch.arange(6.0, device=cuda)
    assert torch.equal(all_reduce_sum(nccl_mesh, x.clone()), x)
    flags = x > 2.0
    assert torch.equal(gather_along(nccl_mesh, flags), flags)


@pytest.mark.parametrize("halo", [1, 2])
def test_windowed_filter_on_one_nccl_rank(cuda, nccl_mesh, halo):
    """World size 1 over NCCL: the window is the whole sequence, K1 runs
    at offsets +-1..+-halo, bit-identical to the global filter."""
    from multiviewstitch_tpu_torch.parallel.view_windows import (
        check_consistency_windowed)
    assert (nccl_mesh.backend, nccl_mesh.size) == ("nccl", 1)
    sc = make_scene(n_frames=8, width=160, height=120, bumps=0.15,
                    n_lat=32, n_lon=48, arc_deg=60.0, device=cuda)
    d = _noisy(sc, cuda)
    offs = tuple(o for o in range(-halo, halo + 1) if o)
    got = _counted("consistency", lambda: check_consistency_windowed(
        d, sc.cams, mesh=nccl_mesh, halo=halo, **K1_KW))
    assert torch.equal(got, tc.check_consistency_reference(
        d, sc.cams, offsets=offs, **K1_KW))


def test_sharded_ba_on_one_nccl_rank(cuda, nccl_mesh):
    """solve_ba_sharded over one NCCL rank against solve_ba on the card:
    the same math with the RMSE summed in the grouped layout, so within
    the card-vs-CPU test's bound."""
    from multiviewstitch_tpu_torch.parallel import ba_dist
    from multiviewstitch_tpu_torch.solvers import ba
    K, ci, pi, uv, n_pts, n_cams, st = _synth_ba()
    prob = ba.make_problem(K, ci, pi, uv, n_pts, n_cams=n_cams,
                           fixed_cams=[0, n_cams - 1], device=cuda)
    s0 = ba.BAState(*(torch.as_tensor(a, device=cuda) for a in st))
    want, rw = ba.solve_ba(prob, s0, iters=20)
    blocks = ba_dist.BAPointBlocks(prob.K, prob.cam_of, prob.uv_g,
                                   prob.pt_obs_mask, prob.fixed_cams)
    got, rg = ba_dist.solve_ba_sharded(blocks, s0, nccl_mesh, iters=20)
    assert rg < 1.0 and abs(rg - rw) <= 1e-4
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("fill", [0.0, 20.0])
def test_k1_no_valid_pixel(scene, fill):
    d, cams = scene
    got = _k1_matches_plain(torch.full_like(d, fill), cams)
    assert (got == 0).all()


def _k2_matches_plain(d, cams, **kw):
    kw = dict(min_dsp=1e-3, max_dsp=10.0, **kw)
    got = _counted("oriented_points",
                   lambda: tps.sample_oriented_points(d, cams, **kw))
    ref = tps.sample_oriented_points_reference(d, cams, **kw)
    assert torch.equal(got.points, ref.points)
    assert (got.conf == ref.conf).float().mean().item() >= 0.9999
    assert (got.valid == ref.valid).float().mean().item() >= 0.9999
    both = got.valid & ref.valid
    nerr = (got.normals - ref.normals).abs().amax(-1)[both]
    assert (nerr <= 1e-6).float().mean().item() >= 0.9999
    return got, ref


@pytest.fixture(scope="module")
def scene12(cuda):
    sc = make_scene(n_frames=12, width=160, height=120, bumps=0.15,
                    n_lat=64, n_lon=96, arc_deg=60.0, device=cuda)
    return _noisy(sc, cuda, seed=1), sc.cams


@pytest.mark.parametrize("r,nbr_num,nbr_step", [
    (1, 1, 1), (2, 1, 1), (3, 1, 1), (2, 5, 1), (3, 5, 1), (2, 1, 2),
    (2, 5, 2)])
def test_k2_oriented_points_match_plain(scene12, r, nbr_num, nbr_step):
    d, cams = scene12
    got, ref = _k2_matches_plain(d, cams, sample_radius=r, nbr_num=nbr_num,
                                 nbr_step=nbr_step, dsp_err=0.01,
                                 conf_min=0.6)
    n, h, w = d.shape
    assert got.points.shape == (n, len(range(0, h, r)) * len(range(0, w, r)),
                                3)
    assert got.valid.any() and (got.conf > 0).any() and (got.conf < 1).any()


def test_k2_valid_pixels_on_every_border(cuda):
    # cameras 0.7 from the centre of a sphere of radius ~0.5: the surface
    # fills every image, so the tangents of the border samples wrap
    sc = make_scene(n_frames=3, width=160, height=120, bumps=0.05, n_lat=32,
                    n_lon=48, arc_deg=30.0, cam_radius=0.7, device=cuda)
    d = sc.disparity
    assert all(bool((e > 0).all()) for e in (d[:, 0], d[:, -1], d[:, :, 0],
                                             d[:, :, -1]))
    for r in (1, 2, 3):
        got, _ = _k2_matches_plain(d, sc.cams, sample_radius=r, nbr_num=1,
                                   nbr_step=1, dsp_err=0.05, conf_min=0.0)
        n, h, w = d.shape
        keep = got.valid.reshape(n, len(range(0, h, r)), -1)
        assert keep[:, 0].any() and keep[:, :, 0].any()


def test_k2_one_frame_has_conf_one(scene):
    d, cams = scene
    got, _ = _k2_matches_plain(d[:1].contiguous(), cams[:1], sample_radius=2,
                               nbr_num=2, nbr_step=1, dsp_err=0.01,
                               conf_min=0.6)
    assert (got.conf == 1).all() and got.valid.any()


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


def _tri_uvz(tris, zs):
    """uvz [1,3T,3] and faces [T,3] of triangles given in pixels."""
    tris = np.asarray(tris, np.float32).reshape(-1, 3, 2)
    zs = np.broadcast_to(np.asarray(zs, np.float32), tris.shape[:2])
    uvz = np.concatenate([tris, zs[..., None]], -1).reshape(1, -1, 3)
    faces = np.arange(uvz.shape[1], dtype=np.int32).reshape(-1, 3)
    return uvz, faces


def _k3_case(name):
    """(uvz [N,V,3], faces [F,3], face_ok [N,F], h, w) in numpy."""
    rng = np.random.default_rng(3)
    if name == "tile borders":      # edges and corners on 16-px borders
        uvz, faces = _tri_uvz([[[16, 16], [48, 16], [48, 32]],
                               [[16, 16], [48, 32], [16, 32]],
                               [[31, 0], [47, 15], [31, 15]],
                               [[0, 32], [15, 47], [0, 47]]],
                              [[0.5, 0.6, 0.7], [0.5, 0.7, 0.4],
                               [0.3, 0.3, 0.3], [0.9, 0.8, 0.7]])
        h, w = 48, 64
    elif name == "one face over every tile":   # 120 is not a tile multiple
        uvz, faces = _tri_uvz([[[-500, -400], [3000, -300], [-200, 2600]]],
                              [[0.5, 0.6, 0.7]])
        h, w = 120, 160
    elif name == "more pairs than the first bins":   # the rerun
        uvz, faces = _tri_uvz([[[-500, -400], [3000, -300], [-200, 2600]]] *
                              6, rng.uniform(0.2, 1.0, size=(6, 3)))
        h, w = 120, 160
    elif name == "3000 faces in one tile":     # > one 256-record chunk
        c = rng.uniform(17.0, 30.0, size=(3000, 1, 2))
        tris = c + rng.uniform(-0.6, 0.6, size=(3000, 3, 2))
        uvz, faces = _tri_uvz(tris, rng.uniform(0.2, 1.0, size=(3000, 3)))
        h, w = 48, 64
    else:
        raise KeyError(name)
    ok = np.ones((uvz.shape[0], len(faces)), bool)
    return uvz, faces, ok, h, w


def _k3_pairs():
    """The (face, tile) pairs K3 counted since ``_k3_matches_plain`` reset
    the counter."""
    return profiling.counters(kernels.PAIRS)[kernels.PAIRS]


def _k3_matches_plain(cuda, uvz, faces, ok, h, w):
    uvz, faces, ok = (torch.as_tensor(a, device=cuda) for a in (uvz, faces,
                                                                ok))
    profiling.reset_counters(kernels.PAIRS)
    got = _counted("raster", lambda: tr.raster(uvz, faces, ok, height=h,
                                               width=w))
    ref = tr.raster_reference(uvz, faces, ok, height=h, width=w)
    assert torch.equal(got, ref)
    return got


@pytest.mark.parametrize("name", ["tile borders", "one face over every tile",
                                  "more pairs than the first bins",
                                  "3000 faces in one tile"])
def test_k3_binning_cases_match_plain(cuda, name):
    uvz, faces, ok, h, w = _k3_case(name)
    got = _k3_matches_plain(cuda, uvz, faces, ok, h, w)
    if name in ("one face over every tile", "more pairs than the first bins"):
        assert (got > 0).all()
        n_tiles = -(-h // 16) * -(-w // 16)
        assert _k3_pairs() == len(faces) * n_tiles   # its own count
    if name == "3000 faces in one tile":
        assert (got[0, 16:32, 16:32] > 0).sum() > 100
        assert (got[0, :16] == 0).all() and (got[0, 32:] == 0).all()
    if name == "tile borders":
        assert got[0, 16, 16] > 0 and got[0, 32, 48] > 0


def test_k3_frames_with_their_own_face_ok(cuda):
    verts, faces = uv_sphere(32, 48, bumps=0.15)
    cams = ring_cameras(3, width=96, img_height=72, arc_deg=60.0,
                        device=cuda)
    uvz, fi, ok = tr.project_vertices(
        torch.as_tensor(verts, device=cuda),
        torch.as_tensor(faces, device=cuda),
        torch.ones(len(faces), dtype=torch.bool, device=cuda), cams)
    keep = np.random.default_rng(5).random(ok.shape) < [[1.0], [0.5], [0.1]]
    ok = ok & torch.as_tensor(keep, device=cuda)
    got = _k3_matches_plain(cuda, uvz, fi, ok, 72, 96)
    hits = (got > 0).flatten(1).sum(1)
    assert hits[0] > hits[2] > 0


@pytest.mark.parametrize("name", ["zero faces", "all faces culled"])
def test_k3_zero_pairs_writes_zeros(cuda, name):
    uvz, faces, ok, h, w = _k3_case("tile borders")
    uvz = np.concatenate([uvz, uvz])
    if name == "zero faces":
        faces = faces[:0]
    ok = np.zeros((2, len(faces)), bool)
    got = _k3_matches_plain(cuda, uvz, faces, ok, h, w)
    assert got.shape == (2, h, w) and (got == 0).all()
    assert _k3_pairs() == 0


def test_k3_raises_on_out_of_range_face_id(cuda):
    uvz, faces, ok, h, w = _k3_case("tile borders")
    faces[2, 1] = uvz.shape[1]
    with pytest.raises(ValueError, match="out of range"):
        tr.raster(torch.as_tensor(uvz, device=cuda),
                  torch.as_tensor(faces, device=cuda),
                  torch.as_tensor(ok, device=cuda), height=h, width=w)


@pytest.mark.parametrize("name", ["3000 faces in one tile",
                                  "more pairs than the first bins"])
def test_k3_makes_one_host_read(cuda, name):
    import warnings
    uvz, faces, ok, h, w = (torch.as_tensor(a, device=cuda)
                            if isinstance(a, np.ndarray) else a
                            for a in _k3_case(name))
    tr.raster(uvz, faces, ok, height=h, width=w)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tr.raster(uvz, faces, ok, height=h, width=w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message) for c in caught
             if "synchroniz" in str(c.message)]
    assert len(syncs) == 1, syncs


def test_wrappers_check_their_inputs(scene):
    d, cams = scene
    kw = dict(sample_radius=2, nbr_num=1, nbr_step=1, min_dsp=0.0,
              max_dsp=1.0, dsp_err=0.05, conf_min=0.5)
    C = cams.centers()
    with pytest.raises(ValueError):
        kernels.oriented_points(d, cams.K, cams.R, cams.t, C[:2], **kw)
    with pytest.raises(ValueError):
        kernels.oriented_points(d, cams.K, cams.R, cams.t, C,
                                **dict(kw, sample_radius=0))
    with pytest.raises(TypeError):
        kernels.oriented_points(d.half(), cams.K, cams.R, cams.t, C, **kw)
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


# --- K4 (csrc/stencil.cu): the Poisson field's stencils against the plain
# code of ops/poisson on the card, bit for bit (the solver has no atomics)

K4_SIDES = [16, 18, 32, 64, 256]      # 18: the one-cell-a-thread kernels
K4_SCREEN = 1e-3 * 4 ** 3             # the scan's screen three levels down


def _plain_poisson(fn, *args, **kw):
    """fn of ops.poisson with K4 off: its plain code on CUDA tensors."""
    from multiviewstitch_tpu_torch.ops import poisson as P
    with pytest.MonkeyPatch.context() as m:
        m.setattr(P, "_on_k4", lambda t: False)
        return fn(*args, **kw)


def _k4_fields(cuda, side, n, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed * 1000 + side)
    return [torch.randn((side,) * 3, generator=g, device=cuda)
            for _ in range(n)]


@pytest.mark.parametrize("side", K4_SIDES)
def test_k4_sweep_matvec_and_restriction_match_plain(cuda, side):
    from multiviewstitch_tpu_torch.ops import poisson as P
    x, b = _k4_fields(cuda, side, 2)
    got = _counted("stencil", lambda: kernels.stencil_jacobi(
        x, b, torch.empty_like(x), screen=K4_SCREEN, omega=0.8))
    want = _plain_poisson(P._smooth_jacobi, x.clone(), b, K4_SCREEN, 1)
    assert torch.equal(got, want)
    got = _counted("stencil",
                   lambda: kernels.stencil_matvec(x, screen=K4_SCREEN))
    assert torch.equal(got, _plain_poisson(P._matvec, x, K4_SCREEN))
    got = _counted("stencil", lambda: kernels.stencil_residual_restrict(
        x, b, screen=K4_SCREEN))
    want = _plain_poisson(lambda: P._restrict2(
        P._residual(x, b, K4_SCREEN)).mul_(4.0))
    assert torch.equal(got, want)


@pytest.mark.parametrize("side", K4_SIDES)
def test_k4_prolongation_and_blur_match_plain(cuda, side):
    from multiviewstitch_tpu_torch.ops import poisson as P
    x, a = _k4_fields(cuda, side, 2, seed=1)
    e, = _k4_fields(cuda, side // 2, 1, seed=2)
    got = _counted("stencil",
                   lambda: kernels.stencil_prolong_add(x.clone(), e))
    assert torch.equal(got, _plain_poisson(P._prolong_add, x.clone(), e))
    for ax in range(3):
        got = _counted("stencil", lambda: kernels.stencil_box_blur(
            a, torch.empty_like(a), axis=ax))
        want = a.clone()
        P._acc_roll(want, a, 1, ax)
        P._acc_roll(want, a, -1, ax)
        assert torch.equal(got, want.div_(3.0)), f"axis {ax}"
    assert torch.equal(P._box_blur_(a.clone()),
                       _plain_poisson(P._box_blur_, a.clone()))


@pytest.mark.parametrize("side", [9, 16])
def test_k4_coarsest_solve_matches_plain(cuda, side):
    from multiviewstitch_tpu_torch.ops import poisson as P
    b, = _k4_fields(cuda, side, 1, seed=3)
    x = torch.zeros_like(b)
    got = _counted("stencil", lambda: P._smooth_jacobi(x, b, K4_SCREEN, 42))
    want = _plain_poisson(P._smooth_jacobi, torch.zeros_like(b), b,
                          K4_SCREEN, 42)
    assert got is x and torch.equal(got, want)


def test_k4_multigrid_solve_matches_plain(cuda):
    """12 V-cycles at 256^3 from one right-hand side (the blurred noise of
    a seed): K4 equals the plain code bit for bit, in 12 x 25 launches
    (levels 256, 128, 64, 32: two sweeps, the restricted residual, the
    prolongation, two sweeps; 16^3: one launch)."""
    from multiviewstitch_tpu_torch.ops import poisson as P
    noise, = _k4_fields(cuda, 256, 1, seed=4)
    b = P._box_blur_(noise)
    torch.cuda.synchronize()
    before = kernels.launch_counts()["stencil"]
    got = P._multigrid(b, 1e-3, 12)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["stencil"] - before == 12 * 25
    want = _plain_poisson(P._multigrid, b, 1e-3, 12)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["stencil"] - before == 12 * 25
    assert torch.isfinite(got).all() and float(got.abs().max()) > 0
    assert torch.equal(got, want)


def test_k4_refuses_aliased_fields(cuda):
    x, b = _k4_fields(cuda, 32, 2)
    with pytest.raises(ValueError, match="share memory"):
        kernels.stencil_jacobi(x, b, x, screen=1e-3, omega=0.8)
    with pytest.raises(ValueError, match="share memory"):
        kernels.stencil_box_blur(x, x, axis=0)
    with pytest.raises(ValueError):
        kernels.stencil_jacobi(x, b.cpu(), torch.empty_like(x), screen=1e-3,
                               omega=0.8)


# --- Poisson and the per-frame meshes: the card (K4 and plain PyTorch)
# against the same code on the CPU


def _sphere_cloud(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("depth", [6, 8])
def test_reconstruct_poisson_cuda_matches_cpu(cuda, depth):
    """Tolerance: the card's splat is an atomic scatter-add, so its float
    sums come in another order: vertex and face counts within 1 %, the
    symmetric chamfer distance under 0.05 voxel."""
    from multiviewstitch_tpu_torch.ops.poisson import reconstruct_poisson
    pts, nrm = _sphere_cloud()
    gv, gf = reconstruct_poisson(pts, nrm, depth=depth, device=cuda)
    cv, cf = reconstruct_poisson(pts, nrm, depth=depth, device="cpu")
    assert len(cv) > 1000
    assert abs(len(gv) - len(cv)) <= 0.01 * len(cv)
    assert abs(len(gf) - len(cf)) <= 0.01 * len(cf)
    g, c = torch.as_tensor(gv, device=cuda), torch.as_tensor(cv, device=cuda)

    def mean_nearest(p, q):
        return torch.cat([torch.cdist(a, q).min(1).values
                          for a in p.split(4096)]).mean()
    ch = 0.5 * (mean_nearest(g, c) + mean_nearest(c, g))
    voxel = 2.4 / ((1 << depth) - 1)
    assert float(ch) < 0.05 * voxel
    r = np.linalg.norm(gv, axis=1)
    assert abs(r.mean() - 1.0) < 0.01


def _slab_case(name, cuda):
    """(field, occ, origin, spacing, slab) of a grid the extraction slabs:
    the 384-wide sheet of tests/test_torch_tracing.py at z 31.5 (every
    vertex in the cell layer both slabs hold), or an analytic sphere field
    at 512^3 in a 6-voxel band."""
    if name == "sheet":
        z = torch.arange(40, dtype=torch.float32, device=cuda)
        field = (31.5 - z)[:, None, None].expand(40, 384, 384).contiguous()
        occ = torch.ones(field.shape, dtype=torch.bool, device=cuda)
        return field, occ, torch.zeros(3, device=cuda), 1.0, 32
    ax = torch.arange(512, dtype=torch.float32, device=cuda) - 255.7
    r = torch.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                   + ax[None, None, :] ** 2)
    return (200.3 - r, (r - 200.3).abs() < 6,
            torch.tensor([-1.2, -1.1, -1.3], device=cuda), 2.4 / 511, 64)


@pytest.mark.parametrize("name", ["sheet", "sphere512"])
def test_slab_weld_cuda_matches_numpy_weld(cuda, name):
    """The Z-slab extraction welded on the card gives, bit for bit, the
    host numpy weld of the same slabs' surface nets (also run on the card),
    in two copies to the host (three with the cells)."""
    from multiviewstitch_tpu_torch.ops import poisson as P
    field, occ, o, spacing, slab = _slab_case(name, cuda)
    want = slabs_numpy(field, occ, o, spacing, slab)
    for cells, copies in ((False, 2), (True, 3)):
        before = profiling.counters("poisson.")
        got = P._extract_mesh_slabs(field, occ, o, spacing, slab=slab,
                                    return_cells=cells)
        after = profiling.counters("poisson.")
        assert after["poisson.extract_copies"] - before.get(
            "poisson.extract_copies", 0) == copies
        welded = after["poisson.slab_vertices"] - before.get(
            "poisson.slab_vertices", 0)
        assert welded > len(got[0]) > 10000
        assert len(got) == copies
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _solvers_without_host_sync(cuda, plain: bool) -> int:
    """_cg, a V-cycle and the blur under CUDA's sync check (no sync may
    happen); returns the K4 launches they made."""
    import warnings
    from multiviewstitch_tpu_torch.ops import poisson as P
    g = torch.Generator(device=cuda).manual_seed(0)
    b = torch.randn(64, 64, 64, generator=g, device=cuda)
    x = torch.zeros_like(b)
    P._cg(b[:32, :32, :32].contiguous(), 1e-3, 3)
    P._box_blur_(b.clone())
    torch.cuda.synchronize()
    before = kernels.launch_counts()["stencil"]
    with pytest.MonkeyPatch.context() as m:
        if plain:
            m.setattr(P, "_on_k4", lambda t: False)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                P._cg(b[:32, :32, :32].contiguous(), 1e-3, 20)
                P._vcycle(x, b, 1e-3)
                P._box_blur_(b.clone())
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message) for c in caught
             if "synchroniz" in str(c.message)]
    assert syncs == []
    assert torch.isfinite(x).all()
    return kernels.launch_counts()["stencil"] - before


def test_poisson_solvers_make_no_host_sync(cuda):
    """On K4: _cg's 21 matvecs, the V-cycle's 13 launches (levels 64 and
    32, then 16^3) and the blur's 6."""
    assert _solvers_without_host_sync(cuda, plain=False) == 21 + 13 + 6


def test_poisson_plain_solvers_make_no_host_sync(cuda):
    assert _solvers_without_host_sync(cuda, plain=True) == 0


@pytest.mark.parametrize("edge", [0.0, 0.03])
def test_grid_mesh_cuda_matches_cpu(cuda, edge):
    """Tolerance: faces and texture indices exact, vertices atol 1e-6."""
    from multiviewstitch_tpu_torch.ops.meshing import grid_mesh
    sc = make_scene(n_frames=1, width=160, height=120, bumps=0.15, n_lat=64,
                    n_lon=96, arc_deg=60.0, device=cuda)
    d = _noisy(sc, cuda)[0]
    kw = dict(min_dsp=1e-3, max_dsp=10.0, smooth_thres=0.5,
              edge_sz_thres=edge)
    gm = grid_mesh(d, sc.cams[0], **kw)
    cm = grid_mesh(d.cpu(), sc.cams[0].to("cpu"), **kw)
    assert gm.num_faces == cm.num_faces > 100
    assert torch.equal(gm.faces.cpu(), cm.faces)
    assert torch.equal(gm.tex_index.cpu(), cm.tex_index)
    torch.testing.assert_close(gm.vertices.cpu(), cm.vertices, atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# mode 2 (deform, render, depth refine) on the card against its CPU path
# ---------------------------------------------------------------------------

def _demo_meshes(dev):
    from multiviewstitch_tpu_torch.cli import demo_scan
    from multiviewstitch_tpu_torch.interop import mesh_from_numpy
    from multiviewstitch_tpu_torch.models.template_body import make_template
    tv, tf, tl = make_template()
    sv, sf = demo_scan()
    return (mesh_from_numpy(tv, tf, tl, device=dev),
            mesh_from_numpy(sv, sf, device=dev))


def test_deform_stage_cuda_matches_cpu(cuda):
    """Tolerance 1e-3 max abs (the bound the CPU tests hold the port to
    JAX with one set of discrete choices): the rigid alignment's sums run
    in float64 on the card, and the fit orders near-ties by index, so the
    card and the CPU pick the same controls."""
    from multiviewstitch_tpu_torch.cli import VIEW_RAY
    from multiviewstitch_tpu_torch.pipeline.deform_render import deform_stage
    got = deform_stage(*_demo_meshes(cuda), VIEW_RAY, deform_passes=2)
    want = deform_stage(*_demo_meshes("cpu"), VIEW_RAY, deform_passes=2)
    assert got.vertices.device.type == "cuda"
    gap = (got.vertices.cpu() - want.vertices).abs().max().item()
    print(f"deform_stage cuda vs cpu: max abs {gap:.3g}")
    assert gap <= 1e-3


def test_rigid_alignment_cuda_matches_cpu(cuda):
    """The alignment's numeric cores on the card: the part labels and the
    control set equal, the aligned template within 1e-6."""
    from multiviewstitch_tpu_torch.cli import VIEW_RAY, demo_scan
    from multiviewstitch_tpu_torch.models.template_body import make_template
    from multiviewstitch_tpu_torch.solvers.alignment import align
    from multiviewstitch_tpu_torch.solvers.deformation import (
        fit_normals, uniform_sampling)
    tv, tf, tl = make_template()
    sv, sf = demo_scan()
    f = torch.as_tensor(tf, dtype=torch.int64)
    tn = fit_normals(torch.as_tensor(tv), f).numpy()
    sn = fit_normals(torch.as_tensor(sv), f).numpy()
    got, want = (align(tv, tn, tl, sv, sn, sf, VIEW_RAY, device=d)
                 for d in (cuda, "cpu"))
    gap = np.abs(got.src - want.src).max()
    print(f"rigid alignment cuda vs cpu: max abs {gap:.3g}")
    assert np.array_equal(got.t_labels, want.t_labels)
    assert gap <= 1e-6
    assert np.array_equal(uniform_sampling(got.src.astype(np.float32)),
                          uniform_sampling(want.src.astype(np.float32)))


def test_find_correspondences_and_fit_rotation_cuda_match_cpu(cuda):
    """Tolerance: accept masks equal, targets and rotations within 1e-5."""
    from multiviewstitch_tpu_torch.solvers import deformation as TD
    g = torch.Generator().manual_seed(0)
    scan = torch.randn(3000, 3, generator=g)
    scan = scan / scan.norm(dim=1, keepdim=True)
    snrm = scan * torch.where(torch.rand(3000, 1, generator=g) < 0.1, -1, 1)
    c = torch.randn(200, 3, generator=g)
    c = 0.95 * c / c.norm(dim=1, keepdim=True)
    cn = c + 0.2 * torch.randn(200, 3, generator=g)
    want = TD.find_correspondences(c, cn, scan, snrm, proj_len_err=0.2,
                                   proj_dist_err=0.1)
    got = TD.find_correspondences(c.to(cuda), cn.to(cuda), scan.to(cuda),
                                  snrm.to(cuda), proj_len_err=0.2,
                                  proj_dist_err=0.1)
    assert torch.equal(got.valid.cpu(), want.valid)
    assert 0 < int(want.valid.sum()) < 200
    torch.testing.assert_close(got.targets.cpu(), want.targets, atol=1e-5,
                               rtol=0)
    S = torch.randn(4096, 3, 3, generator=g)
    S[:16, :, 2] = 0.0                               # rank 2
    torch.testing.assert_close(TD.fit_rotation(S.to(cuda)).cpu(),
                               TD.fit_rotation(S), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dense", [True, False])
def test_arap_solve_cuda_matches_cpu(cuda, dense):
    """Tolerance 1e-4 (cuSOLVER's Cholesky and the atomic scatters sum in
    another order)."""
    from multiviewstitch_tpu_torch.solvers import deformation as TD
    v, f = uv_sphere(20, 28, radius=1.0)
    edges = TD.mesh_edges(f)
    w = TD.cotangent_weights(v, f, edges)
    sidx = TD.uniform_sampling(v)
    con = np.zeros(len(v), bool)
    con[sidx] = True
    tgt = v.copy()
    tgt[sidx] += 0.03 * np.random.default_rng(3).normal(
        size=(len(sidx), 3)).astype(np.float32)

    def prob(dev):
        return TD.ARAPProblem(
            torch.as_tensor(v, device=dev),
            torch.as_tensor(edges.astype(np.int64), device=dev),
            torch.as_tensor(w, device=dev), torch.as_tensor(con, device=dev),
            torch.as_tensor(tgt, device=dev))
    got = TD.arap_solve(prob(cuda), outer_iters=3, dense=dense).cpu()
    want = TD.arap_solve(prob("cpu"), outer_iters=3, dense=dense)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_pivots_cuda_has_the_cpu_signs(cuda):
    from multiviewstitch_tpu_torch.solvers.pca import pivots
    g = torch.Generator().manual_seed(1)
    for _ in range(8):
        q, _ = torch.linalg.qr(torch.randn(3, 3, generator=g))
        p = (torch.randn(2000, 3, generator=g) * torch.tensor(
            [2.0, 1.0, 0.3])) @ q.T + torch.randn(3, generator=g)
        gv, gw, gc = pivots(p.to(cuda))
        cv, cw, cc = pivots(p)
        assert gv.device.type == "cuda"
        assert torch.equal(torch.sign(gv.cpu()), torch.sign(cv))
        torch.testing.assert_close(gv.cpu(), cv, atol=1e-5, rtol=0)


def test_refine_depth_cuda_matches_cpu_without_host_sync(cuda):
    """Tolerance 1e-4 of the data range (the CG's dot products sum in
    another order); no host read in the 100 iterations."""
    import warnings
    from multiviewstitch_tpu_torch.ops.depth_refine import refine_depth
    sc = make_scene(n_frames=4, width=160, height=120, bumps=0.15, n_lat=64,
                    n_lon=96, arc_deg=60.0, device=cuda)
    model = sc.disparity
    meas = _noisy(sc, cuda)
    meas[:, 40:60, 60:90] = 0.0
    refine_depth(meas, model, iters=3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = refine_depth(meas, model)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message) for c in caught if "synchroniz" in str(c.message)]
    assert syncs == []
    want = refine_depth(meas.cpu(), model.cpu())
    span = float(want.max() - want.min())
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * span


def test_render_stage_cuda_matches_cpu_bit_for_bit(cuda, tmp_path):
    """K3 against its plain version through the whole render stage: the
    vertex map and the projection are elementwise, so the card and the CPU
    rasterise the same numbers."""
    from multiviewstitch_tpu_torch.core.transforms import Similarity
    from multiviewstitch_tpu_torch.pipeline.deform_render import render_stage
    tmpl, _ = _demo_meshes("cpu")
    c = tmpl.vertices.mean(0)
    cams = ring_cameras(6, radius=2.6, width=240, img_height=320,
                        length_focal=300.0, look_at=tuple(c.tolist()),
                        height=float(c[1]), device="cpu")
    yaw = np.radians(9.0)
    T = Similarity(torch.tensor(1.12), torch.tensor(
        [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
         [-np.sin(yaw), 0, np.cos(yaw)]], dtype=torch.float32),
        torch.tensor([0.12, -0.06, 0.1]))
    before = kernels.launch_counts()["raster"]
    got = render_stage(tmpl.vertices.to(cuda), tmpl.faces.to(cuda), [T],
                       [cams.to(cuda)], out_dirs=[str(tmp_path)])[0]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["raster"] == before + 1
    want = render_stage(tmpl.vertices, tmpl.faces, [T], [cams])[0]
    assert (want > 0).float().mean() > 0.02
    assert torch.equal(got.cpu(), want)
    assert len(list((tmp_path / "DATA" / "Render").glob("*.raw"))) == 6


def _synth_ba(n_cams=8, n_pts=512, seed=0):
    """Cameras on an arc, every camera seeing every point, 0.5 px noise,
    a perturbed start; the first and last cameras fixed at their true
    poses (the scale is then no free direction, so two devices' states
    compare)."""
    from multiviewstitch_tpu_torch.solvers import ba
    rng = np.random.default_rng(seed)
    K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1]],
                 np.float32)
    pts = rng.uniform(-0.8, 0.8, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    rvec = np.stack([[0.0, (i - n_cams / 2) * 0.04, 0.0]
                     for i in range(n_cams)]).astype(np.float32)
    tvec = np.stack([[0.1 * i, 0.0, 0.0]
                     for i in range(n_cams)]).astype(np.float32)
    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    R = ba.rodrigues(torch.as_tensor(rvec)).numpy()
    pc = np.einsum("cij,pj->cpi", R, pts) + tvec[:, None]
    uv = np.stack([K[0, 0] * pc[..., 0] / pc[..., 2] + K[0, 2],
                   K[1, 1] * pc[..., 1] / pc[..., 2] + K[1, 2]], -1)
    uv = uv[cam_idx, pt_idx] + rng.normal(size=(len(cam_idx), 2)) * 0.5
    st = [a + rng.normal(size=a.shape).astype(np.float32) * m
          for a, m in ((rvec, 0.01), (tvec, 0.03), (pts, 0.02))]
    for a, true in zip(st[:2], (rvec, tvec)):        # the fixed cameras
        a[[0, -1]] = true[[0, -1]]
    return K, cam_idx, pt_idx, uv, n_pts, n_cams, st


def test_solve_ba_cuda_matches_cpu_without_host_sync(cuda):
    """20 LM iterations on the card against the CPU: RMSE within 1e-4 px,
    each state array within 1e-4 of its largest magnitude (the points sit
    at z ~ 5, where float32 sums in another order part by ~3e-4 after 20
    iterations); no host read inside the LM loop."""
    import warnings
    from multiviewstitch_tpu_torch.solvers import ba
    K, ci, pi, uv, n_pts, n_cams, st = _synth_ba()
    out = {}
    for dev in ("cpu", cuda):
        prob = ba.make_problem(K, ci, pi, uv, n_pts, n_cams=n_cams,
                               fixed_cams=[0, n_cams - 1], device=dev)
        s0 = ba.BAState(*(torch.as_tensor(a, device=dev) for a in st))
        if dev == "cpu":
            out[dev] = ba.solve_ba(prob, s0, iters=20)
            continue
        best = ba.reprojection_rmse(prob, s0)
        lam = torch.full((), 1e-3, device=cuda)
        ba.lm_step(prob, s0, best, lam)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                s = s0
                for _ in range(20):
                    s, best, lam = ba.lm_step(prob, s, best, lam)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [str(c.message) for c in caught
                 if "synchroniz" in str(c.message)]
        assert syncs == []
        out["cuda"] = (s, float(best))
    (sc, rc), (sg, rg) = out["cpu"], out["cuda"]
    assert rc < 1.0 and abs(rc - rg) <= 1e-4
    for a, b in zip(sg, sc):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def test_refine_pose_graph_cuda_matches_cpu(cuda):
    """Three sequences, consecutive and skip edges, 1 mm match noise, a
    perturbed chain: the card's refinement within 1e-4 of the CPU's."""
    from multiviewstitch_tpu_torch.core.transforms import (Similarity,
                                                           apply_points,
                                                           inverse)
    from multiviewstitch_tpu_torch.solvers import pose_graph as pg
    from multiviewstitch_tpu_torch.solvers.ba import rodrigues
    rng = np.random.default_rng(0)

    def sim(s, r, t):
        return Similarity(torch.tensor(s, dtype=torch.float32),
                          rodrigues(torch.tensor(r, dtype=torch.float32)),
                          torch.tensor(t, dtype=torch.float32))
    gt = [sim(1.15, [0.1, 0.3, -0.2], [0.2, -0.1, 0.3]),
          sim(1.3, [-0.2, 0.1, 0.15], [-0.1, 0.2, 0.1]),
          Similarity.identity(device="cpu")]
    world = torch.as_tensor(rng.normal(size=(400, 3)).astype(np.float32))
    pairs = []
    for k, l in ((0, 1), (1, 2), (0, 2)):
        w = world[rng.choice(400, 80, replace=False)]
        q = apply_points(inverse(gt[l]), w).numpy()
        pairs.append((k, l, apply_points(inverse(gt[k]), w).numpy(),
                      q + rng.normal(size=q.shape).astype(np.float32) * 1e-3,
                      np.ones(80, bool)))
    init = [sim(float(T.s) * 1.03, [0.02, -0.01, 0.03], [0, 0, 0])
            for T in gt[:2]]
    init = [Similarity(a.s, a.R @ T.R, T.t + 0.02)
            for a, T in zip(init, gt[:2])] + [gt[2]]
    got, rg = pg.refine_pose_graph(init, pg.build_data(pairs, 128,
                                                       device=cuda))
    want, rc = pg.refine_pose_graph(init, pg.build_data(pairs, 128,
                                                        device="cpu"))
    assert rc < 0.01 and abs(rg - rc) <= 1e-4
    for a, b in zip(got, want):
        for x, y in zip((a.s, a.R, a.t), (b.s, b.R, b.t)):
            torch.testing.assert_close(x, y, atol=1e-4, rtol=0)


def test_align_refine_ba_on_the_demo_cuda(cuda, tmp_path):
    """align --demo --refine ba --device cuda recovers the demo similarity
    (test_e2e_align's bounds), with K1 and K2 launched."""
    from multiviewstitch_tpu_torch.cli import main
    from multiviewstitch_tpu_torch.core.transforms import rotation_angle_deg
    from multiviewstitch_tpu_torch.io.srt import load_srt
    kernels.reset_launch_counts()
    stages = []
    assert main(["align", "--demo", "--refine", "ba", "--device", "cuda",
                 "--workdir", str(tmp_path)],
                stage=lambda n, fn: stages.append(n) or fn()) == 0
    counts = kernels.launch_counts()
    assert counts["consistency"] > 0 and counts["oriented_points"] > 0
    assert "refine_s" in stages
    T = load_srt(str(tmp_path / "Result" / "SRT.txt"))[0]
    R = np.array([[0.9689124, 0.0, 0.24740396], [0.0, 1.0, 0.0],
                  [-0.24740396, 0.0, 0.9689124]])
    assert abs(float(T.s) - 1.25) <= 0.05 * 1.25
    assert rotation_angle_deg(T.R, R) < 3.0
    assert np.linalg.norm(T.t.numpy() - [0.1, -0.05, 0.15]) < 0.08
