"""The Augmented Autoencoder, encode-only (port of augmentedautoencoder_tpu/models/aae.py).

Serving needs only the encoder; the decoder and the training losses come
with the training slice of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .encoder import Encoder

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AAE(nn.Module):
    """`encode(x)` is the deterministic latent code (a VAE returns its mean)."""

    def __init__(
        self,
        input_shape: Tuple[int, int, int] = (128, 128, 3),
        latent_space_size: int = 128,
        num_filters: Tuple[int, ...] = (128, 256, 512, 512),
        kernel_size_encoder: int = 5,
        strides: Tuple[int, ...] = (2, 2, 2, 2),
        batch_norm: bool = False,
        variational: float = 0.0,
        precision: str = "float32",
    ):
        super().__init__()
        if precision not in _DTYPES:
            raise ValueError(f"unknown precision: {precision!r}")
        self.variational = variational
        self.encoder = Encoder(
            input_shape=tuple(input_shape),
            latent_space_size=latent_space_size,
            num_filters=tuple(num_filters),
            kernel_size=kernel_size_encoder,
            strides=tuple(strides),
            batch_norm=batch_norm,
            variational=variational > 0,
            compute_dtype=_DTYPES[precision],
        )

    @classmethod
    def from_config(cls, cfg, precision: Optional[str] = None) -> "AAE":
        """Dims from a TrainConfig; `precision` overrides cfg.precision."""
        return cls(
            input_shape=cfg.shape,
            latent_space_size=cfg.latent_space_size,
            num_filters=tuple(cfg.num_filter),
            kernel_size_encoder=cfg.kernel_size_encoder,
            strides=tuple(cfg.strides),
            batch_norm=cfg.batch_normalization,
            variational=cfg.variational,
            precision=precision or cfg.precision,
        )

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        out = self.encoder(x)
        return out[0] if self.variational > 0 else out

    forward = encode
