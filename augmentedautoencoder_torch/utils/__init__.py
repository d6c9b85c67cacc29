"""Small helpers of the port (copies of augmentedautoencoder_tpu/utils)."""

from .misc import batch_iteration_indices

__all__ = ["batch_iteration_indices"]
