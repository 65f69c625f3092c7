"""K1, the per-pixel consistency filter (``csrc/consistency.cu``): one call
per sequence on its disparity [N,H,W], offsets -1 and +1."""

from __future__ import annotations

from . import existing_neighbours, least_seconds

KERNELS = r"^(void )?\(anonymous namespace\)::consistency_kernel\b"


def bound(disparity, min_dsp: float, max_dsp: float,
          offsets=(-1, 1)) -> float:
    """Reads and writes each disparity once (plus 84 B of cameras a frame);
    25 flops a valid pixel (1/d, unprojection) and 88 a valid pixel and
    existing neighbour (two projections of 25, an unprojection of 24 and
    1/d, two roundings of 4, the error test of 5)."""
    n, h, w = disparity.shape
    valid = ((disparity >= min_dsp) & (disparity <= max_dsp)).reshape(
        n, -1).sum(1).tolist()
    nb = existing_neighbours(n, offsets)
    pairs = sum(v * k for v, k in zip(valid, nb))
    return least_seconds(8 * n * h * w + 84 * n, 25 * sum(valid) + 88 * pairs)
