"""The port's copy of the QEM mesh simplification (ops/simplify.py) against
the JAX package's on the same meshes: exactly equal."""

import numpy as np
import pytest

from multiviewstitch_tpu.ops.simplify import simplify_mesh as j_simplify
from multiviewstitch_tpu.pipeline.fixtures import uv_sphere
from multiviewstitch_tpu_torch.ops.simplify import simplify_mesh


@pytest.mark.parametrize("ratio", [0.5, 0.25])
def test_simplify_equals_jax(ratio):
    v, f = uv_sphere(12, 16, radius=0.5, bumps=0.1)
    got_v, got_f = simplify_mesh(v, f, ratio)
    want_v, want_f = j_simplify(v, f, ratio)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)
    assert len(got_v) <= max(int(len(v) * ratio), 4)
    assert got_f.max() < len(got_v)
