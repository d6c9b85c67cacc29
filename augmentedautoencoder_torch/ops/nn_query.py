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

  * `make_cosine_top1_sharded`, `make_cosine_topk_sharded` -- the
    row-sharded queries over a `parallel` mesh: each rank scores its block
    of rows with the kernels above (top-1: `cosine_top1_cuda`; top-k:
    `grouped_codebook_topk` on the block as a one-plane slab), and the
    (B, k) candidates are all-gathered and ranked again.

Codebook rows are expected pre-normalized. Ranked results follow
`lax.top_k`: best first, equal scores by the lower index.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel.distributed import all_gather_rows
from ..parallel.mesh import axis_index

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


def _rerank_shards(vals: Tensor, idcs: Tensor, group, k: int) -> Tuple[Tensor, Tensor]:
    """The global top-k from every rank's (B, k) candidates (global indices):
    one all-gather of both, packed as f64 (exact for f32 scores and int32
    indices), laid out shard-major, so a stable ranking sends equal scores
    to the lowest global index, as `lax.top_k` over the whole matrix."""
    b = vals.shape[0]
    packed = torch.stack([vals.double(), idcs.double()])[None]  # (1, 2, B, k)
    gathered = all_gather_rows(packed, group)  # (W, 2, B, k)
    vg = gathered[:, 0].permute(1, 0, 2).reshape(b, -1)  # (B, W * k)
    ig = gathered[:, 1].permute(1, 0, 2).reshape(b, -1)
    top, pos = topk_lowest_index(vg, k)
    return top.float(), torch.gather(ig, 1, pos).to(torch.int32)


def _built_by_one_rank(z: Tensor, group, built: list) -> None:
    """Before a sharded query's first launch: rank 0 of the group builds the
    kernel library while the other ranks wait, then they load its build
    (one nvcc run a host, not one a rank)."""
    if built or z.device.type != "cuda":
        return
    import torch.distributed as dist

    from . import _cuda

    if dist.get_rank(group) == 0:
        _cuda.lib()
    dist.barrier(group=group)
    built.append(True)


def make_cosine_top1_sharded(mesh, axis: str = "data"):
    """Row-sharded codebook query (the JAX package's
    `make_cosine_top1_sharded`): the codebook's rows shard over `axis`, the
    queries are replicated. Each rank scores its block of rows
    [r * N/W, (r + 1) * N/W) with `cosine_top1_cuda` (B3 on a GPU; the JAX
    local formula: f32 normalize, cast to the codebook dtype, f32 products),
    and the ranks' (value, global index) pairs are all-gathered and ranked:
    the traffic is O(B * W) scalars, never the (B, N) matrix.

    Returns (z, block) -> (vals (B,) f32, idcs (B,) int32), the same on
    every rank; `block` is this rank's rows
    (`parallel.codebook_sharding(mesh, cb, shard_rows=True, axis=axis)`),
    stored as `cosine_top1_cuda` takes them (zero columns up to the
    kernels' width)."""
    group, index, built = mesh.get_group(axis), axis_index(mesh, axis), []

    def query(z: Tensor, block: Tensor) -> Tuple[Tensor, Tensor]:
        _built_by_one_rank(z, group, built)
        vals, idcs = cosine_top1_cuda(z, block)
        vals, idcs = _rerank_shards(vals[:, None], idcs[:, None] + index * block.shape[0], group, 1)
        return vals[:, 0], idcs[:, 0]

    return query


def make_cosine_topk_sharded(mesh, k: int, axis: str = "data"):
    """Row-sharded top-k query (the JAX package's `make_cosine_topk_sharded`)
    for the serving aggregation path: each rank ranks its own block's top-k
    with `grouped_codebook_topk` (B2 on a GPU, k <= 32) on the block as a
    one-plane slab of its rows, offsets the indices to global ones, then
    the (B, k) candidates are all-gathered and ranked again (O(B * k * W)
    scalars). Ties resolve to the lowest global row index.

    Returns (z, block) -> (vals (B, k) f32, idcs (B, k) int32), the same on
    every rank; `block` as for `make_cosine_top1_sharded`."""
    from .multi_codebook import grouped_codebook_topk  # multi_codebook imports this module

    group, index, built = mesh.get_group(axis), axis_index(mesh, axis), []

    def query(z: Tensor, block: Tensor) -> Tuple[Tensor, Tensor]:
        _built_by_one_rank(z, group, built)
        n = block.shape[0]
        vals, idcs = grouped_codebook_topk(z, block[None], 0, n, k=k)
        return _rerank_shards(vals, idcs + index * n, group, k)

    return query
