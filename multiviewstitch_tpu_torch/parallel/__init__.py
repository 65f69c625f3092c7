"""The multi-device layer on torch.distributed: meshes (process groups),
the windowed consistency filter, the edge-sharded sweep, and the sharded
BA and ARAP solves."""

from .mesh import (init_distributed, make_mesh, shard_along, replicated,
                   pad_to_multiple)
from .ba_dist import (BAPointBlocks, group_by_point, gn_step_sharded,
                      solve_ba_sharded, reprojection_rmse_blocks)
from .arap_dist import arap_solve_sharded, pad_edges

__all__ = [
    "init_distributed", "make_mesh", "shard_along", "replicated",
    "pad_to_multiple",
    "BAPointBlocks", "group_by_point", "gn_step_sharded",
    "solve_ba_sharded", "reprojection_rmse_blocks",
    "arap_solve_sharded", "pad_edges",
]
