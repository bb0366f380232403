"""Multi-device sharding: grid cells and animation frames over a device mesh.

Port of ``libavif_tpu/parallel``. The reference is single-process; its
concurrency axes map to mesh axes here:

  AV1 tiles within a frame   -> intra-device blocking (the kernels' lanes)
  grid image cells           -> "cells" mesh axis (spatial parallelism)
  animation frames / GOPs    -> "frames" mesh axis (data parallelism)

One process drives every device of the mesh (``shard.py``): each takes
its block of a batch as one call on its own stream, and the halo rows
travel as device-to-device copies. ``hosts.py`` shards GOPs over
spawned processes, each with its own device.
"""

from .shard import (  # noqa: F401
    CODEC_MESH_AXES,
    encode_cells_sharded,
    decode_cells_sharded,
    exchange_cell_boundaries,
    make_codec_mesh,
)
