"""Model modules of the port."""

from .aae import AAE, AAEOutputs
from .decoder import Decoder
from .encoder import Encoder, same_padding

__all__ = ["AAE", "AAEOutputs", "Decoder", "Encoder", "same_padding"]
