"""Small helpers of the port (copies of augmentedautoencoder_tpu/utils)."""

from .misc import batch_iteration_indices, md5_of, tiles

__all__ = ["batch_iteration_indices", "md5_of", "tiles"]
