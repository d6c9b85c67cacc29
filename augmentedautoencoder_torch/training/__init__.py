"""Checkpoint I/O of the port (training itself comes in a later slice)."""

from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
