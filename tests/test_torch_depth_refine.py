"""The port's ops/depth_refine.refine_depth against the JAX package's on the
same numpy inputs from a seed. Tolerance: within 1e-4 of the data range
(the CG's dot products sum in another order); pixels observed in neither
source are 0 in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiviewstitch_tpu.ops.depth_refine import refine_depth as j_refine
from multiviewstitch_tpu_torch.ops.depth_refine import refine_depth

torch.set_num_threads(2)


def _maps(seed, n=3, h=40, w=52):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    model = np.where((yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (0.4 * h) ** 2,
                     0.5 + 0.002 * xx, 0.0).astype(np.float32)
    model = np.repeat(model[None], n, 0) * (1 + 0.1 * np.arange(n))[:, None,
                                                                     None]
    meas = model * (1 + 0.02 * rng.normal(size=model.shape))
    meas[:, 10:18, 12:30] = 0.0                          # holes
    meas[:, :, :6] = 0.45                                 # outside the model
    meas[:, :3] = 0.0
    model[:, :, :3] = 0.0                                 # seen by neither
    return meas.astype(np.float32), model.astype(np.float32)


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(edge_aware=False)),
    (2, dict(lam_model=2.0, lam_smooth=0.05, iters=40))])
def test_refine_depth_matches_jax(seed, kw):
    meas, model = _maps(seed)
    want = np.asarray(j_refine(jnp.asarray(meas), jnp.asarray(model), **kw))
    got = refine_depth(torch.as_tensor(meas), torch.as_tensor(model), **kw)
    got = got.numpy()
    span = float(want.max() - want.min())
    assert np.abs(got - want).max() <= 1e-4 * span
    dead = (meas <= 0) & (model <= 0)
    assert dead.any() and np.all(got[dead] == 0) and np.all(want[dead] == 0)
    hole = (meas <= 0) & (model > 0)
    assert np.all(np.abs(got[hole] - model[hole]) < 0.05 * model[hole])
