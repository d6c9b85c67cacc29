"""Convolutional encoder (port of augmentedautoencoder_tpu/models/encoder.py).

4 x (stride-2 conv -> ReLU [-> BatchNorm]) -> flatten -> linear latent, with
the JAX package's conventions kept exactly so its weights carry over:

  * SAME padding as Flax computes it: for kernel 5, stride 2 on an even
    input that is 1 before and 2 after, not the symmetric `padding=2`;
  * BatchNorm AFTER the ReLU (eps 1e-5, running statistics at inference;
    in training Flax's batch statistics and running-average update, see
    `FlaxBatchNorm2d`);
  * the feature map is flattened in NHWC order, so the Flax `latent`
    kernel maps over by a plain transpose;
  * optional VAE head: sigma = softplus(1e-8 + Dense(x)).

Precision follows the JAX package's `compute_dtype`: the parameters stay
f32 and each call casts them to the compute dtype, as a Flax layer with
`dtype=bfloat16` casts its input, kernel and bias (`conv2d`, `linear`);
the gradients reach the f32 parameters through those casts. BatchNorm
keeps f32 parameters and statistics and normalizes in f32 before it casts
its output back. The latent head (and the VAE's sigma) runs in f32 from
the bf16 map cast up (`head_dtype`).

Inputs are NHWC floats in [0, 1], as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.fused_upconv import conv2d
from ..parallel.distributed import all_reduce_sum


def head_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """The dtype of the f32 heads under `compute_dtype`: f32, or f64 when
    the whole model runs in f64 (the checks' reference)."""
    return torch.promote_types(compute_dtype, torch.float32)


def conv_in(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` on x in x's dtype, its parameters cast to it (Flax
    `nn.Conv(dtype=...)`)."""
    return conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), stride=conv.stride, padding=conv.padding)


def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`lin` on x in x's dtype, its parameters cast to it (Flax
    `nn.Dense(dtype=...)`): in bf16 the bias is added to the rounded
    product, as Flax adds it."""
    w, b = lin.weight.to(x.dtype), lin.bias.to(x.dtype)
    if x.dtype != torch.bfloat16:
        return F.linear(x, w, b)
    return F.linear(x, w) + b


class _FlaxBatchNorm:
    """Flax `nn.BatchNorm` semantics in training mode, on torch's BatchNorm
    state (same parameter and buffer names, so checkpoints interchange):

      * batch statistics in f32 as Flax computes them: mean, and the biased
        variance mean(x^2) - mean^2 clipped at 0;
      * y = (x - mean) * (rsqrt(var + eps) * weight) + bias;
      * running statistics keep 0.99 of the old value and fold in the
        BIASED batch variance (torch's momentum weights the new batch and
        folds in the unbiased one, which no flag turns off); as Flax
        keeps no batch count, `num_batches_tracked` stays as it was.

    In eval mode the same y on the running statistics. Either way x is
    normalized in f32 (f64 in an f64 model), as Flax's `force_float32_reductions`
    promotes it, and y is cast back to x's dtype: in bf16 the parameters
    and statistics stay f32.

    With a process `group` (`sync_batch_norm`), the training statistics are
    the global batch's, as XLA computes the JAX mean over the whole sharded
    batch: the f32 sums of x and x^2 are all-reduced over the group (the
    gradient flows back through the sum to every rank) and divided by the
    global count, so every rank folds the same running statistics."""

    flax_momentum = 0.99
    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.to(head_dtype(x.dtype))
        if self.training:
            if self.group is None:
                mean, mean_sq = xf.mean(dims), (xf * xf).mean(dims)
            else:
                count = xf.numel() // xf.shape[1] * dist.get_world_size(self.group)
                sums = all_reduce_sum(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]), self.group)
                mean, mean_sq = sums[0] / count, sums[1] / count
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.flax_momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def sync_batch_norm(model: nn.Module, group) -> nn.Module:
    """Set the process group over which `model`'s BatchNorms take their
    training statistics (None: this process's batch alone). Returns model."""
    for m in model.modules():
        if isinstance(m, _FlaxBatchNorm):
            m.group = group
    return model


class FlaxBatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """Per-channel BatchNorm over (B, C, H, W) with Flax's training update."""


class FlaxBatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """Per-feature BatchNorm over (B, F) with Flax's training update."""


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of Flax/XLA `padding="SAME"` on one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Encoder(nn.Module):
    def __init__(
        self,
        input_shape: Tuple[int, int, int] = (128, 128, 3),
        latent_space_size: int = 128,
        num_filters: Sequence[int] = (128, 256, 512, 512),
        kernel_size: int = 5,
        strides: Sequence[int] = (2, 2, 2, 2),
        batch_norm: bool = False,
        variational: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        h, w, c = input_shape
        self.kernel_size = kernel_size
        self.strides = tuple(strides)
        self.variational = variational
        self.compute_dtype = compute_dtype
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList() if batch_norm else None
        self._pads = []
        for filters, stride in zip(num_filters, strides):
            self.convs.append(nn.Conv2d(c, filters, kernel_size, stride=stride))
            if batch_norm:
                self.bns.append(FlaxBatchNorm2d(filters, eps=1e-5))
            ph, pw = same_padding(h, kernel_size, stride), same_padding(w, kernel_size, stride)
            self._pads.append((pw[0], pw[1], ph[0], ph[1]))
            h, w, c = math.ceil(h / stride), math.ceil(w / stride), filters
        flat = h * w * c
        self.latent = nn.Linear(flat, latent_space_size)
        self.latent_sigma = nn.Linear(flat, latent_space_size) if variational else None

    def forward(self, x: torch.Tensor):
        """x: (B, H, W, C) float. Returns z (B, latent) f32, or (z, sigma)."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        for i, conv in enumerate(self.convs):
            x = F.relu(conv_in(conv, F.pad(x, self._pads[i])))
            if self.bns is not None:
                x = self.bns[i](x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).to(head_dtype(self.compute_dtype))  # NHWC flatten
        z = linear(self.latent, x)
        if not self.variational:
            return z
        return z, F.softplus(1e-8 + linear(self.latent_sigma, x))
