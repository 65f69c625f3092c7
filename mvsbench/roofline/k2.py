"""K2, the oriented point sampler (``csrc/sampling.cu``): one call per
sequence on its consistency-filtered disparity [N,H,W]."""

from __future__ import annotations

from . import existing_neighbours, least_seconds

KERNELS = r"^(void )?\(anonymous namespace\)::oriented_points_kernel\b"


def bound(n: int, h: int, w: int, sample_radius: int, nbr_num: int,
          nbr_step: int) -> float:
    """Reads the disparity once (plus 96 B of cameras and centre a frame)
    and writes 29 B a sample; 25 flops a pixel it unprojects (each sample
    and its four +-1 neighbours, wrapped), 32 a sample (tangents, cross
    product, length, normalisation, flip) and 32 a sample and existing
    neighbour frame (projection, rounding, 1/z, the agreement test)."""
    r = sample_radius
    ys, xs = range(0, h, r), range(0, w, r)
    need = set()
    for dy, dx in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
        rows = {(y + dy) % h for y in ys}
        cols = {(x + dx) % w for x in xs}
        need.update((y, x) for y in rows for x in cols)
    samples = len(ys) * len(xs)
    offs = [s * k * nbr_step for k in range(1, nbr_num + 1) for s in (-1, 1)]
    votes = samples * sum(existing_neighbours(n, offs))
    flops = 25 * n * len(need) + 32 * n * samples + 32 * votes
    return least_seconds(4 * n * h * w + 96 * n + 29 * n * samples, flops)
