"""Batched nearest neighbour for the ICP correspondence step (port of
augmentedautoencoder_tpu/ops/icp_nn.py).

For every lane (one detection) and every source point, the closest of the
lane's destination points in 3-D: src, dst (n, N, 3) f32 -> (dist (n, N)
f32, idx (n, N) int32). As in the JAX package, both clouds are first
centred on each lane's destination centroid (nearest neighbours do not
move under a translation, and coordinates of object-radius scale keep f32
resolution where camera-frame ones, at z ~ 700 mm, would not), and the
squared distance splits as |s|^2 + (|d|^2 - 2 s.d): only the bracket
depends on j, so only it is minimised, written with s' = -2 s as

    score = ((s'x dx + s'y dy) + s'z dz) + |d|^2,

every product and sum rounded on its own. Ties go to the lowest index.

  * `batched_nn_torch` -- the plain version: the same scores as broadcast
    elementwise ops, in blocks of source points, and the first minimum;
  * `batched_nn_cuda` -- the whole function in csrc/icp_nn.cu
    (counterpart of the Pallas `batched_nn_pallas`): two launches, the
    centring, the search and the distances inside them; it counts its calls
    in `batched_nn_cuda.launches`;
  * `batched_nn` -- the wrapper: the plain version for CPU tensors, the
    kernel for CUDA tensors, ValueError otherwise.

The kernel repeats the plain version's arithmetic operation for operation
(the centroid by the same `tree_sum` order and the same f32 reciprocal,
every product and sum rounded on its own), so on one device the two agree
bit for bit. Every sum here is an explicit order of elementwise adds
(`sum3`, `tree_sum`), never a library reduction, whose order differs
between the CPU and the GPU, and a mean multiplies by the f32 reciprocal
of its count (`tree_mean`). CUDA's true division by a host scalar computes
that product, while the CPU divides, so a mean written `x / n` rounded
apart on the two devices. Likewise every square root is `sqrt_rn`: torch's
f32 square root on the CPU is off by one ulp on ~0.7% of inputs (its
vectorized path), where CUDA's and the kernel's `__fsqrt_rn` are
correctly rounded. The ICP loop (pose/icp.py) is built from these
sums and from elementwise IEEE operations (+, -, *, /, sqrt), so it is
meant to compute the same bits on the CPU and on the GPU; chip_smoke.py
phase 5 compares one-detection frames of both.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_SCORE_BLOCK = 1 << 22  # score elements per block of the plain version (16 MB f32)


def sum3(v: Tensor) -> Tensor:
    """(v0 + v1) + v2 over the last axis of size 3."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def tree_sum(x: Tensor, dim: int) -> Tensor:
    """Sum over `dim` by pairwise halving after zero-padding to a power of
    two: elementwise adds in a fixed order, so every device rounds alike."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.cat([x, x.new_zeros((width - n,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = x[:half] + x[half:]
    return x[0]


def recip_f32(n: int) -> float:
    """1 / n rounded to f32: the factor of every mean here, on every device."""
    return float(np.float32(1.0) / np.float32(n))


def sqrt_rn(x: Tensor) -> Tensor:
    """The correctly rounded square root of f32 `x` on every device: the
    f64 root rounded to f32 (53 >= 2 * 24 + 2 bits, so the double rounding
    is innocuous)."""
    return torch.sqrt(x.double()).to(x.dtype)


def tree_mean(x: Tensor, dim: int) -> Tensor:
    """`tree_sum` times the f32 reciprocal of the count: one multiply that
    the CPU and the GPU round alike (`x / n` divides on the CPU but
    multiplies by the reciprocal on CUDA)."""
    return tree_sum(x, dim) * recip_f32(x.shape[dim])


def _check_clouds(src: Tensor, dst: Tensor) -> None:
    if src.dim() != 3 or src.shape[-1] != 3 or dst.shape != src.shape:
        raise ValueError(f"batched_nn takes (n, N, 3) src and dst, got {tuple(src.shape)}, {tuple(dst.shape)}")
    if src.dtype != torch.float32 or dst.dtype != torch.float32:
        raise ValueError(f"batched_nn takes f32 clouds, got {src.dtype}, {dst.dtype}")


def _operands(src: Tensor, dst: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(s, s' = -2 s, d, |d|^2) of the clouds centred on dst's lane centroid."""
    _check_clouds(src, dst)
    mu = tree_mean(dst, 1)[:, None]
    s = src - mu
    d = dst - mu
    return s, -2.0 * s, d, sum3(d * d)


def _distances(s: Tensor, min_score: Tensor) -> Tensor:
    """sqrt(max(|s|^2 + min score, 0)): the true nearest distance."""
    return sqrt_rn(torch.clamp(sum3(s * s) + min_score, min=0.0))


def min_argmin_torch(sp: Tensor, d: Tensor, dsq: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain (min, argmin) search over `_operands`' s', d and |d|^2:
    (min score (n, N) f32, argmin (n, N) int32), the function of
    csrc/icp_nn.cu."""
    n, N, _ = sp.shape
    sx, sy, sz = (sp[..., k, None].contiguous() for k in range(3))  # (n, N, 1) columns
    dx, dy, dz = (d[:, None, :, k].contiguous() for k in range(3))  # (n, 1, N) rows
    rows = max(1, _SCORE_BLOCK // max(N, 1))
    min_score = torch.empty((n, N), dtype=torch.float32, device=sp.device)
    idx = torch.empty((n, N), dtype=torch.int64, device=sp.device)
    for lane in range(n):
        for a in range(0, N, rows):
            block = slice(a, a + rows)
            score = sx[lane, block] * dx[lane]
            score += sy[lane, block] * dy[lane]
            score += sz[lane, block] * dz[lane]
            score += dsq[lane, None]
            # the first minimum of each row: ties to the lowest index
            torch.min(score, dim=-1, out=(min_score[lane, block], idx[lane, block]))
    return min_score, idx.to(torch.int32)


def batched_nn_torch(src: Tensor, dst: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version: (dist (n, N) f32, idx (n, N) int32)."""
    s, sp, d, dsq = _operands(src, dst)
    min_score, idx = min_argmin_torch(sp, d, dsq)
    return _distances(s, min_score), idx


def batched_nn_cuda(src: Tensor, dst: Tensor) -> Tuple[Tensor, Tensor]:
    """The whole function in csrc/icp_nn.cu, on src's CUDA device: no
    PyTorch op besides the one allocation of outputs and scratch."""
    from ._cuda import batched_nn as launch

    _check_clouds(src, dst)
    out = launch(src.contiguous(), dst.contiguous())
    batched_nn_cuda.launches += 1
    return out


batched_nn_cuda.launches = 0


def batched_nn(src: Tensor, dst: Tensor) -> Tuple[Tensor, Tensor]:
    """For each src point its nearest dst point, per lane: the plain version
    on CPU tensors, the CUDA kernel on CUDA tensors."""
    if src.device.type == "cpu" and dst.device.type == "cpu":
        return batched_nn_torch(src, dst)
    if src.device.type == "cuda" and dst.device == src.device:
        return batched_nn_cuda(src, dst)
    raise ValueError(f"batched_nn: unsupported devices {src.device}, {dst.device}")
