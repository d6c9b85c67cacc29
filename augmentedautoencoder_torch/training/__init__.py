"""Training of the port: checkpoint I/O, the optax-exact optimizer, the
training step and loop."""

from .checkpoint import CheckpointManager
from .state import OptaxOptimizer, make_optimizer
from .trainer import Trainer, make_reconstruction_fn, make_train_step

__all__ = [
    "CheckpointManager",
    "OptaxOptimizer",
    "Trainer",
    "make_optimizer",
    "make_reconstruction_fn",
    "make_train_step",
]
