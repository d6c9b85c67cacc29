"""Model modules of the port."""

from .aae import AAE, AAEOutputs
from .decoder import Decoder, DecoderBank
from .encoder import Encoder, same_padding

__all__ = ["AAE", "AAEOutputs", "Decoder", "DecoderBank", "Encoder", "same_padding"]
