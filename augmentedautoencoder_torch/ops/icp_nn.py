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
  * `batched_nn_cuda` -- the same function with the (min, argmin) search
    in csrc/icp_nn.cu (counterpart of the Pallas `batched_nn_pallas`); it
    counts its launches in `batched_nn_cuda.launches`;
  * `batched_nn` -- the wrapper: the plain version for CPU tensors, the
    kernel for CUDA tensors, ValueError otherwise.

Both share `_operands` and `_distances`, so the kernel sees exactly the
plain version's operands and the two agree bit for bit. Every sum here is
an explicit order of elementwise adds (`sum3`, `tree_sum`), never a library
reduction, whose order differs between the CPU and the GPU: the CPU and
GPU results are then identical too, and so is the ICP loop built on them
(pose/icp.py), even where a lane limit-cycles to its iteration cap and a
last-bit difference would otherwise end it elsewhere.
"""

from __future__ import annotations

from typing import Tuple

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


def tree_mean(x: Tensor, dim: int) -> Tensor:
    return tree_sum(x, dim) / x.shape[dim]


def _operands(src: Tensor, dst: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(s, s' = -2 s, d, |d|^2) of the clouds centred on dst's lane centroid."""
    if src.dim() != 3 or src.shape[-1] != 3 or dst.shape != src.shape:
        raise ValueError(f"batched_nn takes (n, N, 3) src and dst, got {tuple(src.shape)}, {tuple(dst.shape)}")
    if src.dtype != torch.float32 or dst.dtype != torch.float32:
        raise ValueError(f"batched_nn takes f32 clouds, got {src.dtype}, {dst.dtype}")
    mu = tree_mean(dst, 1)[:, None]
    s = src - mu
    d = dst - mu
    return s, -2.0 * s, d, sum3(d * d)


def _distances(s: Tensor, min_score: Tensor) -> Tensor:
    """sqrt(max(|s|^2 + min score, 0)): the true nearest distance."""
    return torch.sqrt(torch.clamp(sum3(s * s) + min_score, min=0.0))


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


def kernel_operands(sp: Tensor, d: Tensor, dsq: Tensor) -> Tuple[Tensor, Tensor]:
    """csrc/icp_nn.cu's inputs: s' (n, N, 3) and rows (x, y, z, |d|^2) (n, N, 4)."""
    return sp.contiguous(), torch.cat([d, dsq[..., None]], dim=-1).contiguous()


def batched_nn_cuda(src: Tensor, dst: Tensor) -> Tuple[Tensor, Tensor]:
    """The (min, argmin) search in csrc/icp_nn.cu, on src's CUDA device."""
    from ._cuda import batched_nn_min

    s, sp, d, dsq = _operands(src, dst)
    min_score, idx = batched_nn_min(*kernel_operands(sp, d, dsq))
    batched_nn_cuda.launches += 1
    return _distances(s, min_score), idx


batched_nn_cuda.launches = 0


def batched_nn(src: Tensor, dst: Tensor) -> Tuple[Tensor, Tensor]:
    """For each src point its nearest dst point, per lane: the plain version
    on CPU tensors, the CUDA kernel on CUDA tensors."""
    if src.device.type == "cpu" and dst.device.type == "cpu":
        return batched_nn_torch(src, dst)
    if src.device.type == "cuda" and dst.device == src.device:
        return batched_nn_cuda(src, dst)
    raise ValueError(f"batched_nn: unsupported devices {src.device}, {dst.device}")
