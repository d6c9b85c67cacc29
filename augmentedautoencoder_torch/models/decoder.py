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


def _stacked(n_objects: int, *shape: int) -> nn.Module:
    """A module holding `weight` (n_objects, *shape) and `bias` (n_objects,
    shape[0]): one layer's parameters for every object, under the names a
    `Decoder` layer gives them."""
    layer = nn.Module()
    layer.weight = nn.Parameter(torch.empty(n_objects, *shape))
    layer.bias = nn.Parameter(torch.empty(n_objects, shape[0]))
    return layer


class DecoderBank(nn.Module):
    """The decoders of a multi-path model (Sundermeyer et al., "Multi-path
    Learning for Object Pose Estimation Across Domains", CVPR 2020): one
    `Decoder` for each of `n_objects` objects, every layer's parameters
    stacked on a leading object axis under the Decoder's names
    (`dense.weight` (n_o, h0 * w0 * C0, latent), `convs.<i>.weight` (n_o,
    Cout, Cin, K, K), `reconstruction.weight`, biases (n_o, C)).

    `forward(z)` takes a batch in object order, (n_o * b_o, latent) with
    object o's rows at o * b_o to (o + 1) * b_o - 1, and decodes each
    object's rows by that object's decoder, as the Decoder computes it in
    the same precision: the dense layer as one batched matmul, each 2x step
    and the head as one grouped phase-kernel convolution whose groups are
    the objects (`upsample2x_conv` on the stack). No Python loop over the
    objects. The bank has every step exactly 2x the last map, and no
    BatchNorm or mask head. Recorded as the span `aae.ops.decoder_bank`."""

    def __init__(
        self,
        n_objects: int,
        output_shape: Tuple[int, int, int] = (128, 128, 3),
        latent_space_size: int = 128,
        num_filters: Sequence[int] = (512, 512, 256, 128),  # already reversed
        kernel_size: int = 5,
        strides: Sequence[int] = (2, 2, 2, 2),  # already reversed
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        h, w, c = output_shape
        if any(s != 2 for s in strides) or h % 2 ** len(strides) or w % 2 ** len(strides):
            raise ValueError(f"a decoder bank takes exact 2x steps: STRIDES {list(strides)} on {h}x{w}")
        self.n_objects = n_objects
        self.compute_dtype = compute_dtype
        h0, w0 = h // 2 ** len(strides), w // 2 ** len(strides)
        self.first = (h0, w0, num_filters[0])
        self.dense = _stacked(n_objects, h0 * w0 * num_filters[0], latent_space_size)
        self.convs = nn.ModuleList(
            _stacked(n_objects, cout, cin, kernel_size, kernel_size)
            for cin, cout in zip(num_filters[:-1], num_filters[1:])
        )
        self.reconstruction = _stacked(n_objects, c, num_filters[-1], kernel_size, kernel_size)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        from ..training.profiler import span  # the training package imports the models

        n = self.n_objects
        h0, w0, c0 = self.first
        with span("ops.decoder_bank"):
            zo = z.to(self.compute_dtype).view(n, -1, z.shape[-1])
            b = zo.shape[1]
            x = F.relu(linear_bank(self.dense, zo))
            # (b, n * C0, h0, w0): object o's map is the o-th group of channels
            x = x.view(n, b, h0, w0, c0).permute(1, 0, 4, 2, 3).reshape(b, n * c0, h0, w0)
            for conv in self.convs:
                x = F.relu(upsample2x_conv(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype)))
            x = x.to(head_dtype(self.compute_dtype))
            head = self.reconstruction
            x = torch.sigmoid(upsample2x_conv(x, head.weight.to(x.dtype), head.bias.to(x.dtype)))
            hh, ww = x.shape[2:]
            return x.view(b, n, -1, hh, ww).permute(1, 0, 3, 4, 2).reshape(n * b, hh, ww, -1)


def linear_bank(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x (n, b, in) through each object's dense layer of a bank, weight (n,
    out, in) and bias (n, out) cast to x's dtype, as `linear` computes one:
    in bf16 the bias added to the rounded product."""
    w, bias = layer.weight.to(x.dtype), layer.bias.to(x.dtype).unsqueeze(1)
    if x.dtype != torch.bfloat16:
        return torch.baddbmm(bias, x, w.transpose(1, 2))
    return torch.bmm(x, w.transpose(1, 2)) + bias
