"""Codebook nearest-neighbour queries (port of augmentedautoencoder_tpu/ops/nn_query.py).

  * `cosine_similarity_topk`, `cosine_similarities`, `cosine_topk` -- plain
    PyTorch: normalize, one f32 matmul, a ranked top-k. General (any k,
    `upright` stride, TTA row means); the JAX package leaves them to XLA.
  * `cosine_top1_cuda` -- the single-codebook top-1 of the estimator path,
    counterpart of the Pallas `cosine_top1_pallas`: on a CUDA tensor it
    launches the streaming top-1 of csrc/codebook_query.cu (the (B, N)
    similarity matrix never exists in device memory); on a CPU tensor it
    runs the plain version `cosine_top1_plain`. Both take a codebook stored
    with zero columns beyond the queries' width (`pad_columns`).

Codebook rows are expected pre-normalized. Ranked results follow
`lax.top_k`: best first, equal scores by the lower index.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def l2_normalize(z: Tensor, dim: int = -1, eps: float = 1e-12) -> Tensor:
    """z / |z| with eps on the SQUARED norm, as the JAX package computes it."""
    return z * torch.rsqrt(torch.clamp((z * z).sum(dim=dim, keepdim=True), min=eps))


def pad_columns(x: Tensor, width: int) -> Tensor:
    """x (..., D) with zero columns appended up to `width` (x itself when D
    is `width`): queries meet a codebook stored at the CUDA kernels' width
    (`_cuda.stream_width`). Zero columns add exact zeros to every score."""
    d = x.shape[-1]
    if d > width:
        raise ValueError(f"width {d} is wider than the codebook's {width}")
    return x if d == width else torch.nn.functional.pad(x, (0, width - d))


def topk_lowest_index(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """`lax.top_k` over the last axis: best first, ties to the lower index.
    `torch.topk` promises no tie order, so this ranks with a stable sort."""
    vals, idcs = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idcs[..., :k]


def _cos(z: Tensor, codebook: Tensor) -> Tensor:
    """(B, N) f32 cosines of normalized f32 queries with the codebook rows."""
    return l2_normalize(z.float()) @ codebook.float().T


def cosine_similarity_topk(z: Tensor, codebook: Tensor, k: int = 1) -> Tuple[Tensor, Tensor]:
    """Top-k cosine matches: (values (B, k), indices (B, k))."""
    return topk_lowest_index(_cos(z, codebook), k)


def cosine_similarities(z: Tensor, codebook: Tensor) -> Tensor:
    """Full (B, N) cosine similarity matrix."""
    return _cos(z, codebook)


def cosine_topk(
    z: Tensor, codebook: Tensor, k: int, stride: int = 1, tta: int = 1
) -> Tuple[Tensor, Tensor]:
    """Ranked top-k with the estimation-path extras: the row mean over `tta`
    jittered crops per detection (detection-major rows) and the `upright`
    stride restriction; indices are global (int32)."""
    cos = _cos(z, codebook)
    if tta > 1:
        cos = cos.reshape(-1, tta, cos.shape[-1]).mean(dim=1)
    if stride > 1:
        cos = cos[:, ::stride]
    vals, idcs = topk_lowest_index(cos, k)
    return vals, (idcs * stride).to(torch.int32)


def cosine_top1_plain(z: Tensor, codebook: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of the top-1 kernel, the formula of `cosine_top1_pallas`:
    f32 normalize, cast to the codebook dtype, f32 products and sums
    (bf16 operands are widened first), first maximum wins. Queries are
    padded with zero columns to the codebook's width."""
    q = pad_columns(l2_normalize(z.float()).to(codebook.dtype), codebook.shape[-1])
    cos = q.float() @ codebook.float().T
    idcs = torch.argmax(cos, dim=1)
    vals = torch.gather(cos, 1, idcs[:, None])[:, 0]
    return vals, idcs.to(torch.int32)


def cosine_top1_cuda(z: Tensor, codebook: Tensor) -> Tuple[Tensor, Tensor]:
    """Best match per query: (values (B,) f32, indices (B,) int32).
    codebook: (N, D') f32 or bf16 rows, D' >= the queries' width, columns
    beyond it zero.

    CUDA tensors launch the hand-written kernel (counted in
    `cosine_top1_cuda.launches`); CPU tensors run `cosine_top1_plain`."""
    if z.device.type == "cpu" and codebook.device.type == "cpu":
        return cosine_top1_plain(z, codebook)
    if z.device.type != "cuda":
        raise ValueError(f"cosine_top1_cuda: unsupported device {z.device}")
    from . import _cuda

    q = pad_columns(l2_normalize(z.float()).to(codebook.dtype), codebook.shape[-1]).contiguous()
    n = codebook.shape[0]
    vals, idcs = _cuda.codebook_top1_stream(q, codebook.contiguous(), 0, n, n)
    cosine_top1_cuda.launches += 1
    return vals, idcs


cosine_top1_cuda.launches = 0


def cosine_top1(z: Tensor, codebook: Tensor) -> Tuple[Tensor, Tensor]:
    """Best match per query: the kernel on a GPU, its plain version on CPU."""
    return cosine_top1_cuda(z, codebook)
