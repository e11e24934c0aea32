"""Multi-chip sharding: grid cells and animation frames over a device mesh.

The reference is single-process; its concurrency axes (SURVEY.md §2.4) map
to mesh axes here:

  AV1 tiles within a frame   -> batched blocks inside one device program
  grid image cells           -> "cells" mesh axis (spatial parallelism)
  animation frames / GOPs    -> "frames" mesh axis (data parallelism)

Cells and frames are independent bitstreams, so the sharded programs need
no collectives; XLA partitions them over the mesh (the reference's
pthreads row-slicing, reformat.c:1611-1748, is replaced by whole-array
device ops). Every device reaches every other at the same rate, so the
frames x cells factorisation is a choice of algorithm, not of topology.
"""

from .shard import (  # noqa: F401
    CODEC_MESH_AXES,
    encode_cells_sharded,
    decode_cells_sharded,
    exchange_cell_boundaries,
    make_codec_mesh,
)
