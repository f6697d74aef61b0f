'''
Multi-device parallelism: shard_map over the ray/pixel axis of a device
mesh with per-device film shards.

The reference is single-device; its "parallelism" rows (SURVEY.md §2.10:
Taichi auto-parallel grids, the grid-stride loop, per-thread stack
arenas) all collapse into whole-array ops inside one program.
What remains to distribute is the pixel/ray axis: each device renders a
contiguous band of image rows into its own film shard (no communication
during rendering — film merging is only needed at readout, and gradient
reduction uses psum over the mesh).
'''

from ptina_tpu.parallel.sharding import (  # noqa: F401
    make_mesh, render_sharded, train_step_sharded,
)
from ptina_tpu.parallel.distributed import (  # noqa: F401
    init_distributed, global_mesh, is_distributed,
)
