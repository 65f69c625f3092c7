"""Per-sequence prep and the match filters: the port against the JAX
package on the same numpy inputs (view synthesis, SIFT, matching, dedup /
SSD / gap filters). Each test states its tolerance and why."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiviewstitch_tpu.ops import features as jf
from multiviewstitch_tpu.ops import filters as jfl
from multiviewstitch_tpu.ops import match as jm
from multiviewstitch_tpu.ops import view_synth as jv
from multiviewstitch_tpu.core.transforms import Similarity as JSim
from multiviewstitch_tpu.pipeline import fixtures as jfx
from multiviewstitch_tpu_torch.ops import features as tf
from multiviewstitch_tpu_torch.ops import filters as tfl
from multiviewstitch_tpu_torch.ops import match as tm
from multiviewstitch_tpu_torch.ops import view_synth as tv

torch.set_num_threads(2)

GT_R = np.array([[0.9689124, 0.0, 0.24740396], [0.0, 1.0, 0.0],
                 [-0.24740396, 0.0, 0.9689124]], np.float32)
GT_S, GT_T = 1.25, np.array([0.1, -0.05, 0.15], np.float32)
KP = dict(max_keypoints=256, margins=(0.02, 0.02, 0.02, 0.02))


@pytest.fixture(scope="module")
def demo():
    """The CLI demo's two sequences (3 frames, 128x96), from the JAX
    fixtures: (gray1, disp1, cams1, gray2, disp2, cams2)."""
    kw = dict(n_frames=3, width=128, height=96, bumps=0.15, n_lat=64,
              n_lon=96, arc_deg=45.0)
    gt = JSim(jnp.float32(GT_S), jnp.asarray(GT_R), jnp.asarray(GT_T))
    base = jfx.make_scene(**kw)
    moved = jfx.make_scene(transform=gt, **kw)
    return (jfx.textured_views(base), np.asarray(base.disparity), base.cams,
            jfx.textured_views(moved), np.asarray(moved.disparity),
            moved.cams)


def test_synthesize_views_matches_jax_where_jax_maps(demo):
    """Values agree to atol 1e-2 (0..255) on JAX's tex >= 0 pixels: JAX
    splits its bilinear weights into bf16 hi/lo parts. JAX's banded warp
    leaves window misses unmapped (-1); the direct warp maps them."""
    gray, cams = demo[0], demo[2]
    K, R = np.array(cams.K[1]), np.array(cams.R[1])
    angles = np.array(jv.view_angles(3, 10.0))
    js = jv.synthesize_views(jnp.asarray(gray[1][..., None]),
                             jnp.asarray(K), jnp.asarray(R),
                             jnp.asarray(angles), axis=1,
                             max_angle_deg=10.0)
    ts = tv.synthesize_views(torch.as_tensor(gray[1][..., None]),
                             torch.as_tensor(K), torch.as_tensor(R),
                             torch.as_tensor(angles), axis=1)
    jt, tt = np.asarray(js.tex_index), ts.tex_index.numpy()
    m = jt >= 0
    assert m.mean() > 0.5
    np.testing.assert_array_equal(tt[m], jt[m])
    np.testing.assert_allclose(ts.images.numpy()[m], np.asarray(js.images)[m],
                               atol=1e-2)
    extra = int(((tt >= 0) & ~m).sum())
    print(f"pixels the direct warp maps beyond JAX's: {extra}")
    # the zero-angle view is the identity warp up to K @ K^-1 rounding
    np.testing.assert_allclose(ts.images[1, ..., 0].numpy(), gray[1],
                               atol=1e-2)
    np.testing.assert_allclose(tv.view_angles(3, 10.0, device="cpu").numpy(),
                               angles)


def _nearest_pairs(jk, tk):
    """For each valid JAX keypoint, the port keypoint within 1 px whose
    scale is within 5 % and whose angle is nearest. Returns (ji, ti)."""
    juv, tuv = np.asarray(jk.uv), tk.uv.numpy()
    jv_, tv_ = np.asarray(jk.valid), tk.valid.numpy()
    js_, ts_ = np.asarray(jk.scale), tk.scale.numpy()
    ja, ta = np.asarray(jk.angle), tk.angle.numpy()
    ji, ti = [], []
    for i in np.flatnonzero(jv_):
        d = np.linalg.norm(tuv - juv[i], axis=1)
        c = np.flatnonzero(tv_ & (d <= 1.0) &
                           (np.abs(ts_ / js_[i] - 1.0) <= 0.05))
        if len(c):
            da = np.abs(np.angle(np.exp(1j * (ta[c] - ja[i]))))
            ji.append(i)
            ti.append(c[np.argmin(da)])
    return np.asarray(ji, int), np.asarray(ti, int)


@pytest.fixture(scope="module")
def detections(demo):
    """JAX and port keypoints of all six demo frames (seq 1, then seq 2)."""
    grays = np.concatenate([demo[0], demo[3]])
    jk = jf.detect_batch(jnp.asarray(grays), **KP)
    tk = tf.detect_batch(torch.as_tensor(grays), **KP)
    return ([jf.Keypoints(*(np.asarray(x[i]) for x in jk)) for i in range(6)],
            [tf.Keypoints(*(x[i] for x in tk)) for i in range(6)])


def _true_uv(uv1, demo, i, j):
    """Where sequence-1 frame i pixels uv1 [K,2] land in sequence-2 frame j
    (depth + the known similarity); also the mask of pixels with depth."""
    from multiviewstitch_tpu.core.cameras import unproject, project
    _, d1, c1, _, _, c2 = demo
    h, w = d1.shape[1:]
    ui = np.clip(np.round(uv1).astype(int), 0, [w - 1, h - 1])
    disp = d1[i][ui[:, 1], ui[:, 0]]
    p = np.asarray(unproject(c1[i], jnp.asarray(uv1),
                             jnp.asarray(1.0 / np.maximum(disp, 1e-3))))
    q = GT_S * p @ GT_R.T + GT_T
    return np.asarray(project(c2[j], jnp.asarray(q))[0]), disp > 1e-3


# every (frame of sequence 1, frame of sequence 2) pair: the edge sweep's
# candidates; equal indices view the same surface from the same pose
PAIRS = tuple((i, j) for i in range(3) for j in range(3))


def _recall(kps, match, demo, tol=3.0):
    """Pooled over PAIRS: the fraction of valid sequence-1 keypoints with
    depth whose match in sequence 2 lands within ``tol`` px of the true
    correspondence."""
    hit = tot = 0
    for i, j in PAIRS:
        k1, k2 = kps[i], kps[3 + j]
        uv1 = np.asarray(k1.uv)
        gt_uv, has_d = _true_uv(uv1, demo, i, j)
        idx2, valid = match(k1, k2)
        ok = np.asarray(k1.valid) & has_d
        err = np.linalg.norm(np.asarray(k2.uv)[idx2] - gt_uv, axis=1)
        hit += int((valid & ok & (err < tol)).sum())
        tot += int(ok.sum())
    return hit / max(tot, 1)


def test_detect_and_describe_agrees_with_jax(demo, detections):
    """Keypoints: same positions (<= 1 px) and scales (<= 5 %) for >= 90 %
    of JAX's; matched descriptors: median cosine >= 0.98; demo-pair match
    recall within 5 points. Exact equality is impossible: JAX casts the
    bilinear weights to bf16, clamps samples to 64-px windows and picks
    candidates with approx_max_k."""
    jks, tks = detections
    n_valid = n_pair = 0
    cos = []
    for jk, tk in zip(jks, tks):
        ji, ti = _nearest_pairs(jk, tk)
        n_valid += int(jk.valid.sum())
        n_pair += len(ji)
        cos.append((jk.desc[ji] * tk.desc.numpy()[ti]).sum(1))
    cos = np.concatenate(cos)
    print(f"keypoints matched {n_pair} of {n_valid}; descriptor cosine "
          f"median {np.median(cos):.4f}")
    assert n_valid > 100 and n_pair >= 0.9 * n_valid
    assert np.median(cos) >= 0.98

    def jmatch(k1, k2):
        m = jm.match_descriptors(jnp.asarray(k1.desc), jnp.asarray(k1.valid),
                                 jnp.asarray(k2.desc), jnp.asarray(k2.valid))
        return np.asarray(m.idx2), np.asarray(m.valid)

    def tmatch(k1, k2):
        m = tm.match_descriptors(k1.desc, k1.valid, k2.desc, k2.valid)
        return m.idx2.numpy(), m.valid.numpy()

    rj, rt = _recall(jks, jmatch, demo), _recall(tks, tmatch, demo)
    print(f"demo-pair recall: jax {rj:.3f}, port {rt:.3f}")
    assert rj > 0.1 and abs(rt - rj) <= 0.05


def test_match_descriptors_exact_on_same_descriptors(detections):
    """Same descriptors in, same matches out: exact."""
    tks = detections[1]
    n_ok = 0
    for i, j in PAIRS:
        d1, v1, d2, v2 = (tks[i].desc, tks[i].valid, tks[3 + j].desc,
                          tks[3 + j].valid)
        for kw in (dict(), dict(distmax=0.5, ratiomax=0.9)):
            jmm = jm.match_descriptors(*(jnp.asarray(x.numpy())
                                         for x in (d1, v1, d2, v2)), **kw)
            tmm = tm.match_descriptors(d1, v1, d2, v2, **kw)
            jv_ = np.asarray(jmm.valid)
            np.testing.assert_array_equal(tmm.valid.numpy(), jv_)
            np.testing.assert_array_equal(tmm.idx2.numpy()[jv_],
                                          np.asarray(jmm.idx2)[jv_])
            np.testing.assert_array_equal(tmm.idx1.numpy(),
                                          np.asarray(jmm.idx1))
            n_ok += int(jv_.sum())
    assert n_ok > 50


def _match_set(seed, m=192, w=64, h=48):
    rng = np.random.default_rng(seed)
    uv1 = np.stack([rng.integers(0, w, m), rng.integers(0, h, m)], -1)
    uv2 = np.stack([rng.integers(0, w, m), rng.integers(0, h, m)], -1)
    dup = rng.integers(0, m, m // 4)
    uv1[dup[1:]] = uv1[dup[:-1]]
    uv2[dup[1:]] = uv2[dup[:-1]]
    mask = rng.random(m) < 0.85
    return uv1.astype(np.int32), uv2.astype(np.int32), mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filters_exact_on_same_inputs(seed):
    """dedup, ssd and gap are integer / comparison logic: exact."""
    uv1, uv2, mask = _match_set(seed)
    ju1, ju2, jmask = map(np.asarray, jfl.dedup_matches(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask)))
    tu1, tu2, tmask = tfl.dedup_matches(torch.as_tensor(uv1),
                                        torch.as_tensor(uv2),
                                        torch.as_tensor(mask))
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    np.testing.assert_array_equal(tu1.numpy()[jmask], ju1[jmask])
    np.testing.assert_array_equal(tu2.numpy()[jmask], ju2[jmask])
    assert jmask.sum() < mask.sum()

    rng = np.random.default_rng(seed + 10)
    g1 = (rng.random((48, 64)) * 255).astype(np.float32)
    g2 = g1 + rng.normal(scale=30.0, size=g1.shape).astype(np.float32)
    for win, err in ((3, 40.0), (2, 25.0)):
        jo = np.asarray(jfl.ssd_filter(jnp.asarray(g1), jnp.asarray(g2),
                                       jnp.asarray(ju1), jnp.asarray(ju1),
                                       jnp.asarray(jmask), win=win,
                                       ssd_err=err))
        to = tfl.ssd_filter(torch.as_tensor(g1), torch.as_tensor(g2), tu1,
                            tu1, tmask, win=win, ssd_err=err).numpy()
        np.testing.assert_array_equal(to, jo)
    assert 0 < jo.sum() < jmask.sum()

    for gap in (16.0, 64.0):
        jg = np.asarray(jfl.gap_filter(jnp.asarray(ju1), jnp.asarray(ju2),
                                       jnp.asarray(jmask), min_gap_sq=gap))
        tg = tfl.gap_filter(tu1, tu2, tmask, min_gap_sq=gap).numpy()
        np.testing.assert_array_equal(tg, jg)
        assert 0 < jg.sum() < jmask.sum()


def test_filters_batch_over_leading_dims():
    sets = [_match_set(s) for s in range(3)]
    uv1 = torch.as_tensor(np.stack([s[0] for s in sets]))
    uv2 = torch.as_tensor(np.stack([s[1] for s in sets]))
    mask = torch.as_tensor(np.stack([s[2] for s in sets]))
    bu1, bu2, bm = tfl.dedup_matches(uv1, uv2, mask)
    bg = tfl.gap_filter(bu1, bu2, bm, min_gap_sq=16.0)
    for i in range(3):
        u1, u2, m = tfl.dedup_matches(uv1[i], uv2[i], mask[i])
        assert torch.equal(u1, bu1[i]) and torch.equal(m, bm[i])
        assert torch.equal(tfl.gap_filter(u1, u2, m, min_gap_sq=16.0), bg[i])
    np.testing.assert_array_equal(
        tfl.margin_mask(12, 16, 0.1, 0.25, 0.33, 0.25, device="cpu").numpy(),
        np.asarray(jfl.margin_mask(12, 16, 0.1, 0.25, 0.33, 0.25)))
