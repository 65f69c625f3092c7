"""The edge-sharded sweep (parallel/match_dist) and the align path through a
mesh, at 1 (in process), 2 and 3 gloo ranks on the CPU, against the port's
unsharded sweep.

RANSAC draws from the counter stream of (seed, sequence pair, edge id,
round, hypothesis, match), so an edge draws the same hypotheses in any
block of any rank and the sharded sweep equals the unsharded one bit for
bit (4 x 2 edges: 3 ranks pad one edge). align_sequences(mesh=) at 2 ranks
on 8 + 8 frames at 96x72 (tests/test_view_windows.py's config-5 scene,
cut to 8 frames a sequence) equals the unsharded run and holds its limits
(s within 8 %, rotation within 4 degrees); with refine="ba" the sharded
solve reduces in another order, so the refined transforms are held within
1e-3 of the unsharded refinement."""

import numpy as np
import pytest
import torch

from multiviewstitch_tpu_torch.cli import demo_config
from multiviewstitch_tpu_torch.core.transforms import (Similarity,
                                                       rotation_angle_deg)
from multiviewstitch_tpu_torch.parallel import mesh as pmesh
from multiviewstitch_tpu_torch.parallel.match_dist import match_edges_sharded
from multiviewstitch_tpu_torch.pipeline.align_seq import (Sequence,
                                                          align_sequences)
from multiviewstitch_tpu_torch.pipeline.fixtures import (make_scene,
                                                         textured_views)
from multiviewstitch_tpu_torch.pipeline.match_edges import (edge_knobs,
                                                            match_edges,
                                                            prep_sequence)
from multiviewstitch_tpu_torch.solvers import srt

torch.set_num_threads(2)

CFG = demo_config().replace(max_keypoints=128, iter_num=64)
KEY = srt.stream_key(0, 1)
N1, N2 = 4, 2                      # the sweep test's edge grid


def config5_gt():
    c, s = 0.9848, 0.1736                      # 10 degrees about +y
    return Similarity(torch.tensor(1.15),
                      torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0],
                                    [-s, 0.0, c]]),
                      torch.tensor([0.1, -0.05, 0.15]))


@pytest.fixture(scope="module")
def seqs():
    kw = dict(n_frames=8, width=96, height=72, bumps=0.15, n_lat=48,
              n_lon=64, arc_deg=120.0, device="cpu")
    scenes = [make_scene(**kw), make_scene(transform=config5_gt(), **kw)]
    return [Sequence(textured_views(sc), sc.disparity, sc.cams)
            for sc in scenes]


def _frames(prep, n):
    return type(prep)(*(x[:n] for x in prep))


@pytest.fixture(scope="module")
def preps(seqs):
    p1, p2 = (prep_sequence(s, CFG) for s in seqs)
    return _frames(p1, N1), _frames(p2, N2)


@pytest.fixture(scope="module")
def unsharded(preps, seqs):
    return (match_edges(*preps, KEY, **edge_knobs(CFG)),
            align_sequences(seqs, CFG, seed=0),
            align_sequences(seqs, CFG, seed=0, refine="ba"))


@pytest.fixture(scope="module")
def sharded(preps, seqs):
    """{world: per-rank results}: the sweep at 1 (in process), 2 and 3
    ranks; at 2, also align_sequences with and without BA."""
    sweep = (match_edges_sharded, (*preps, KEY), edge_knobs(CFG))
    m = pmesh.make_mesh(device="cpu")
    try:
        out = {1: [[match_edges_sharded(*preps, KEY, mesh=m,
                                        **edge_knobs(CFG))]]}
    finally:
        m.close()
    out[2] = pmesh.run_spmd(pmesh.spmd_calls, 2, [
        sweep, (align_sequences, (seqs, CFG), dict(seed=0)),
        (align_sequences, (seqs, CFG), dict(seed=0, refine="ba"))],
        device="cpu")
    out[3] = pmesh.run_spmd(pmesh.spmd_calls, 3, [sweep], device="cpu")
    return out


@pytest.mark.parametrize("world", [1, 2, 3])
def test_stream_is_the_same_draw_in_every_rank_block(world):
    """Each rank's padded block of edge ids draws the rows the whole sweep
    draws for those edges (padding ids repeat the last edge's)."""
    E = N1 * N2
    Ep = E + (-E) % world
    full = srt.stream_bits(srt.RansacStream(KEY, torch.arange(E)), 1, 16, 40)
    for r in range(world):
        b = Ep // world
        eid = torch.arange(r * b, (r + 1) * b).clamp_max(E - 1)
        got = srt.stream_bits(srt.RansacStream(KEY, eid), 1, 16, 40)
        assert torch.equal(got, full[eid])
    assert full.dtype == torch.int64 and int(full.min()) >= 0
    assert int(full.max()) < 1 << 32
    s = full.sort(-1).values            # one hypothesis' draws all differ
    assert bool((s[..., 1:] > s[..., :-1]).all())
    assert abs(float(full.double().mean()) / 2 ** 32 - 0.5) < 0.02


@pytest.mark.parametrize("world", [1, 2, 3])
def test_sharded_sweep_equals_unsharded_bit_for_bit(unsharded, sharded,
                                                    world):
    ref = unsharded[0]
    assert int((ref.num_matches >= 3).sum()) > 0      # RANSAC ran for real
    for r, res in enumerate(sharded[world]):
        eb = res[0]
        for name, a, b in zip(ref._fields, eb, ref):
            assert torch.equal(a, b), f"rank {r}: {name} differs"


def _check_limits(T):
    gt = config5_gt()
    assert abs(float(T.s) - 1.15) / 1.15 < 0.08
    assert rotation_angle_deg(T.R, gt.R) < 4.0


def test_align_through_a_mesh_equals_unsharded(unsharded, sharded):
    ref = unsharded[1]
    _check_limits(ref.transforms[0])
    for r, res in enumerate(sharded[2]):
        got = res[1]
        assert got.keyframes == ref.keyframes, r
        assert got.residuals == ref.residuals, r
        for a, b in zip(got.transforms, ref.transforms):
            for x, y in ((a.s, b.s), (a.R, b.R), (a.t, b.t)):
                assert torch.equal(x, y), r


def test_refine_ba_through_a_mesh_is_within_1e3(unsharded, sharded):
    ref = unsharded[2]
    assert ref.metrics["ba_rmse_px"] <= ref.metrics["ba_rmse_init_px"]
    _check_limits(ref.transforms[0])
    for r, res in enumerate(sharded[2]):
        got = res[2]
        m = got.metrics
        assert m["ba_rmse_px"] <= m["ba_rmse_init_px"], m
        assert abs(m["ba_rmse_px"] - ref.metrics["ba_rmse_px"]) < 1e-3
        _check_limits(got.transforms[0])
        for a, b in zip(got.transforms, ref.transforms):
            for x, y in ((a.s, b.s), (a.R, b.R), (a.t, b.t)):
                np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-3,
                                           err_msg=f"rank {r}")
