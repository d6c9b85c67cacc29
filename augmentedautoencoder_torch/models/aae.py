"""The Augmented Autoencoder (port of augmentedautoencoder_tpu/models/aae.py):
encoder + decoder + the combined loss.

The sub-losses combine as in the reference AE (auto_pose/ae/ae.py:42-53):
reconstruction + NORM_REGULARIZE * reg + VARIATIONAL * KL (+ mask MSE with
the auxiliary mask head, decoder.py:134-142).

`precision` is the JAX package's compute dtype: under "bfloat16" the
convolutions and denses run in bf16 and the latent, reconstruction and mask
heads in f32, while every parameter stays f32, so training updates f32
parameters and every checkpoint holds f32, as the JAX one does. The
bootstrapped loss runs on the f32 reconstruction.

Serving needs only the encoder, so `AAE(...)` builds the encoder alone and
its state dict is the encoder's, the one every serving checkpoint holds.
`AAE(..., decoder=True)` (or `from_config(cfg, train=True)`) adds the
decoder that training needs.

With `n_objects` > 1 (a MODEL_PATH of n_o meshes) the model is the
multi-path encoder (Sundermeyer et al., CVPR 2020): the one encoder shared
by every object and a `DecoderBank` of one decoder an object. A batch is
in object order, b_o = B / n_o rows of each object, row i of object o
decoded by object o's decoder, and the loss is the mean over all rows of
each row's bootstrapped error (with equal rows an object, the mean of the
objects' losses). The variants VARIATIONAL, AUXILIARY_MASK and
BATCH_NORMALIZATION are the one-object model's only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .decoder import Decoder, DecoderBank
from .encoder import Encoder
from .losses import bootstrapped_reconstruction_loss, kl_divergence_loss, mask_loss, norm_regularizer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class AAEOutputs:
    z: torch.Tensor
    reconstruction: torch.Tensor
    pred_mask: Optional[torch.Tensor]
    losses: Dict[str, torch.Tensor]

    @property
    def total_loss(self) -> torch.Tensor:
        return self.losses["total_loss"]


class AAE(nn.Module):
    """`encode(x)` is the deterministic latent code (a VAE returns its mean);
    `forward(x, target)` (needs the decoder) returns AAEOutputs."""

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
        decoder: bool = False,
        kernel_size_decoder: int = 5,
        auxiliary_mask: bool = False,
        loss_type: str = "L2",
        bootstrap_ratio: int = 4,
        norm_regularize: float = 0.0,
        topk_mode: str = "exact",
        n_objects: int = 1,
    ):
        super().__init__()
        if precision not in _DTYPES:
            raise ValueError(f"unknown precision: {precision!r}")
        if n_objects > 1 and (variational > 0 or auxiliary_mask or batch_norm):
            raise ValueError(
                "a multi-path model (MODEL_PATH of several meshes) has no VARIATIONAL, AUXILIARY_MASK or "
                "BATCH_NORMALIZATION variant yet: train it with all three off"
            )
        self.n_objects = n_objects
        self.variational = variational
        self.auxiliary_mask = auxiliary_mask
        self.loss_type = loss_type
        self.bootstrap_ratio = bootstrap_ratio
        self.norm_regularize = norm_regularize
        self.topk_mode = topk_mode
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
        if not decoder:
            self.decoder = None
        elif n_objects > 1:
            self.decoder = DecoderBank(
                n_objects,
                output_shape=tuple(input_shape),
                latent_space_size=latent_space_size,
                num_filters=tuple(reversed(num_filters)),
                kernel_size=kernel_size_decoder,
                strides=tuple(reversed(strides)),
                compute_dtype=_DTYPES[precision],
            )
        else:
            self.decoder = Decoder(
                output_shape=tuple(input_shape),
                latent_space_size=latent_space_size,
                num_filters=tuple(reversed(num_filters)),
                kernel_size=kernel_size_decoder,
                strides=tuple(reversed(strides)),
                batch_norm=batch_norm,
                auxiliary_mask=auxiliary_mask,
                compute_dtype=_DTYPES[precision],
            )

    @classmethod
    def from_config(cls, cfg, precision: Optional[str] = None, train: bool = False) -> "AAE":
        """Dims from a TrainConfig; `precision` overrides cfg.precision;
        `train` adds the decoder and the loss settings."""
        return cls(
            input_shape=cfg.shape,
            latent_space_size=cfg.latent_space_size,
            num_filters=tuple(cfg.num_filter),
            kernel_size_encoder=cfg.kernel_size_encoder,
            strides=tuple(cfg.strides),
            batch_norm=cfg.batch_normalization,
            variational=cfg.variational,
            precision=precision or cfg.precision,
            decoder=train,
            kernel_size_decoder=cfg.kernel_size_decoder,
            auxiliary_mask=cfg.auxiliary_mask,
            loss_type=cfg.loss,
            bootstrap_ratio=cfg.bootstrap_ratio,
            norm_regularize=cfg.norm_regularize,
            topk_mode=cfg.topk_mode,
            # the JAX package's TrainConfig, which tests hand in too, has one object
            n_objects=getattr(cfg, "n_objects", 1),
        )

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        out = self.encoder(x)
        return out[0] if self.variational > 0 else out

    def forward(
        self,
        x: torch.Tensor,
        target: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        shard: Tuple[int, int] = (0, 1),
    ) -> AAEOutputs:
        """Encode x, decode, and score against target (both (B, H, W, C) in
        [0, 1]). A VAE in training decodes z + sigma * noise, the noise given
        or drawn from `generator`; otherwise it decodes the mean. BatchNorm
        uses batch statistics in `self.training` mode. `shard` (index, count)
        says that x is slice `index` of `count` equal slices of a global
        batch: drawn noise is then the global batch's, (count * B, latent),
        and this slice takes its rows, so the ranks decode what one process
        decodes on the global batch."""
        if self.decoder is None:
            raise RuntimeError("this AAE was built without its decoder: build it with decoder=True")
        if self.variational > 0:
            z, q_sigma = self.encoder(x)
            code = z
            if train and (noise is not None or generator is not None):
                if noise is None:
                    index, count = shard
                    b = z.shape[0]
                    noise = torch.randn((count * b,) + tuple(z.shape[1:]), generator=generator,
                                        device=z.device, dtype=z.dtype)[index * b:(index + 1) * b]
                code = z + q_sigma * noise
        else:
            z = self.encoder(x)
            q_sigma = None
            code = z

        dec = self.decoder(code)
        reconstruction, pred_mask = dec if self.auxiliary_mask else (dec, None)

        losses: Dict[str, torch.Tensor] = {}
        total = losses["reconst_loss"] = bootstrapped_reconstruction_loss(
            reconstruction, target, self.bootstrap_ratio, self.loss_type, topk_mode=self.topk_mode
        )
        if self.auxiliary_mask:
            losses["mask_loss"] = mask_loss(pred_mask, target)
            total = total + losses["mask_loss"]
        if self.norm_regularize > 0:
            losses["reg_loss"] = norm_regularizer(z)
            total = total + self.norm_regularize * losses["reg_loss"]
        if self.variational > 0:
            losses["kl_loss"] = kl_divergence_loss(z, q_sigma)
            total = total + self.variational * losses["kl_loss"]
        losses["total_loss"] = total
        if train:
            # latent statistics for the metric writer (reference ae.py:19)
            zd = z.detach()
            losses["z_mean"] = zd.mean()
            losses["z_std"] = zd.std(correction=0)
        return AAEOutputs(z=z, reconstruction=reconstruction, pred_mask=pred_mask, losses=losses)
