"""Model modules of the port."""

from .aae import AAE
from .encoder import Encoder, same_padding

__all__ = ["AAE", "Encoder", "same_padding"]
