"""Decoder (port of augmentedautoencoder_tpu/models/decoder.py):
dense -> ReLU [-> BatchNorm] -> (NN-upsample + conv, ReLU [-> BatchNorm])*
-> NN-upsample -> sigmoid conv [+ sigmoid mask head].

The JAX package's conventions, kept so its weights carry over:

  * the filters and strides arrive REVERSED (coarsest first), and each
    layer's size is int(H / prod(strides[i:])), as the reference computes it;
  * the BatchNorm after the Dense layer normalizes the flat h*w*C output
    (a BatchNorm1d), and the Dense output is read as NHWC (B, h, w, C);
  * a step whose size is exactly twice the last map's, and the
    reconstruction and mask heads where the output is, run as the JAX
    package's `_UpConv`: `ops.fused_upconv.upsample2x_conv`, four
    parity-phase convolutions over the map itself, so the port follows the
    JAX arithmetic, not only its function, and the upsampled map never
    exists; any other step indexes rows and columns by `i * h // th`
    (`_nn_resize`) before the conv. The convolutions keep their
    `nn.Conv2d` parameters, so checkpoints restore unchanged;
  * precision follows the JAX decoder's `compute_dtype`: the parameters
    stay f32 and each call casts them to it (the dense from z cast down,
    every step, fused or resized; BatchNorm normalizes in f32 on f32
    statistics and casts back), and the reconstruction and mask heads run
    in f32 from the map cast up.

Tensors inside are NCHW; the decoder returns NHWC, as the JAX one does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_upconv import upsample2x_conv
from .encoder import FlaxBatchNorm1d, FlaxBatchNorm2d, conv_in, head_dtype, linear


def nn_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of NCHW `x` to `size` (th, tw): output row r
    reads row r * h // th (likewise columns), the JAX package's
    `_nn_resize` (tf.image.resize_nearest_neighbor)."""
    h, w = x.shape[2:]
    th, tw = size
    ridx = torch.arange(th, device=x.device) * h // th
    cidx = torch.arange(tw, device=x.device) * w // tw
    return x.index_select(2, ridx).index_select(3, cidx)


class Decoder(nn.Module):
    """`forward(z)` -> reconstruction (B, H, W, C) in [0, 1], or
    (reconstruction, mask (B, H, W, 1)) with the auxiliary mask head."""

    def __init__(
        self,
        output_shape: Tuple[int, int, int] = (128, 128, 3),
        latent_space_size: int = 128,
        num_filters: Sequence[int] = (512, 512, 256, 128),  # already reversed
        kernel_size: int = 5,
        strides: Sequence[int] = (2, 2, 2, 2),  # already reversed
        batch_norm: bool = False,
        auxiliary_mask: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        h, w, c = output_shape
        self.compute_dtype = compute_dtype
        self.output_hw = (h, w)
        self.auxiliary_mask = auxiliary_mask
        strides = list(strides)
        self.layer_dims = [
            (int(h / np.prod(strides[i:])), int(w / np.prod(strides[i:]))) for i in range(len(strides))
        ]
        h0, w0 = self.layer_dims[0]
        self.first = (h0, w0, num_filters[0])
        self.dense = nn.Linear(latent_space_size, h0 * w0 * num_filters[0])
        self.bn_dense = FlaxBatchNorm1d(h0 * w0 * num_filters[0], eps=1e-5) if batch_norm else None
        # stride-1 convs: torch's "same" puts total // 2 before, as Flax's SAME does
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, kernel_size, padding="same") for cin, cout in zip(num_filters[:-1], num_filters[1:])
        )
        self.bns = (
            nn.ModuleList(FlaxBatchNorm2d(f, eps=1e-5) for f in num_filters[1:]) if batch_norm else None
        )
        self.reconstruction = nn.Conv2d(num_filters[-1], c, kernel_size, padding="same")
        self.mask_head = nn.Conv2d(num_filters[-1], 1, kernel_size, padding="same") if auxiliary_mask else None

    def forward(self, z: torch.Tensor):
        h0, w0, c0 = self.first
        x = F.relu(linear(self.dense, z.to(self.compute_dtype)))
        if self.bn_dense is not None:
            x = self.bn_dense(x)
        x = x.reshape(-1, h0, w0, c0).permute(0, 3, 1, 2)  # NHWC rows, as Flax reshapes
        for i, conv in enumerate(self.convs):
            x = F.relu(resize_conv(conv, x, self.layer_dims[i + 1]))
            if self.bns is not None:
                x = self.bns[i](x)
        x = x.to(head_dtype(self.compute_dtype))
        recon = torch.sigmoid(resize_conv(self.reconstruction, x, self.output_hw)).permute(0, 2, 3, 1)
        if self.mask_head is None:
            return recon
        return recon, torch.sigmoid(resize_conv(self.mask_head, x, self.output_hw)).permute(0, 2, 3, 1)


def resize_conv(conv: nn.Conv2d, x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`conv` applied to `x` resized to `size`, in x's dtype (its parameters
    cast to it): fused where `size` is exactly twice x's (the JAX decoder's
    `_UpConv`), else `nn_resize` then `conv`."""
    h, w = x.shape[2:]
    if tuple(size) == (2 * h, 2 * w):
        return upsample2x_conv(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))
    return conv_in(conv, nn_resize(x, size))
