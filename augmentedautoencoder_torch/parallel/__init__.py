"""Multi-GPU layer of the port (port of augmentedautoencoder_tpu/parallel/):
one process per card on torch.distributed, the (data, model) mesh and its
shard layouts."""

from .distributed import barrier, host_replicate, initialize, is_primary, shutdown, world_size
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_index,
    axis_size,
    batch_sharding,
    codebook_sharding,
    make_mesh,
    replicated,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "axis_index",
    "axis_size",
    "barrier",
    "batch_sharding",
    "codebook_sharding",
    "host_replicate",
    "initialize",
    "is_primary",
    "make_mesh",
    "replicated",
    "shutdown",
    "world_size",
]
