"""Edge-sharded all-pairs matching: view-graph edges over the mesh.

PyTorch counterpart of ``multiviewstitch_tpu/parallel/match_dist.py``
(SURVEY §2's pairwise-work parallelism: the reference's all-pairs match
loop and per-pair RANSAC cascade, FeatureProc.cpp:114-129 and
Processor.cpp:629-833, as a batch of independent view-graph edges). The
edge ids e = i*n2 + j are padded to a multiple of the mesh size and
block-sharded: each rank sweeps its contiguous block with the single-device
per-edge program (``pipeline/match_edges.match_edge_block``), whose RANSAC
draws from the counter stream at (key, edge id), so the sharded sweep
equals the unsharded one bit for bit. Padding edges point at frame pair
(0, 0) and come out invalid (residual inf, count 0). One ``all_gather``
per output assembles the EdgeBatch on every rank.

The frames' prep (descriptors, texIndex, gray, unprojection maps) is
replicated on every rank; ``parallel/view_windows`` is the partitioning
that would keep each edge's frames rank-local at multi-host scale.
"""

from __future__ import annotations

import torch

from ..pipeline.match_edges import EdgeBatch, SequencePrep, match_edge_block
from .mesh import Mesh, block_range, gather_along


def match_edges_sharded(prep1: SequencePrep, prep2: SequencePrep, key: int,
                        *, mesh: Mesh, **edge_knobs) -> EdgeBatch:
    """All n1*n2 edges of a sequence pair, block-sharded over the mesh
    (``edge_knobs``: ``match_edges.edge_knobs(cfg)``)."""
    dev = prep1.gray.device
    n2 = prep2.gray.shape[0]
    E = prep1.gray.shape[0] * n2
    Ep = E + (-E) % mesh.size
    s, e = block_range(mesh, Ep)
    eid = torch.arange(s, e, device=dev)
    real = eid < E
    ei = torch.where(real, eid // n2, 0)
    ej = torch.where(real, eid % n2, 0)
    uv1, uv2, p1, p2, mask, res, nm = match_edge_block(
        prep1, prep2, key, ei, ej, eid.clamp_max(E - 1), **edge_knobs)
    mask = mask & real[:, None]
    res = torch.where(real, res, torch.full_like(res, float("inf")))
    nm = torch.where(real, nm, torch.zeros_like(nm))
    out = [gather_along(mesh, x)[:E]
           for x in (uv1, uv2, p1, p2, mask, res, nm)]
    eall = torch.arange(E, device=dev)
    return EdgeBatch(eall // n2, eall % n2, *out)
