"""Multi-object codebook serving queries (port of augmentedautoencoder_tpu/ops/multi_codebook.py).

All objects' codebooks live in one (O, N_pad, D) slab with true lengths
(`stack_codebooks`). A batch of queries that share one object id scores
only that object's plane:

  * `grouped_codebook_top1` -- the serving top-1 (Pallas `grouped_codebook_top1`);
  * `grouped_codebook_topk` -- the ranked top-k, 1 <= k <= 32, with the
    `upright` stride mask (Pallas `grouped_codebook_topk`).

On CUDA tensors each launches csrc/codebook_query.cu (top-1: the streaming
`aae_codebook_top1_stream`; top-k: the streaming `aae_codebook_topk_stream`)
and counts the launch in its `launches` attribute; on CPU tensors each runs
its plain version (`*_plain`), which follows the JAX function's formula.
Padded rows (index >= n_valid) score -2 and never beat a true row. The
kernels copy rows of a multiple of 16 bytes and score bf16 in steps of 16
columns: callers store the slab with zero columns up to
`_cuda.stream_width` (`pad_slab`), and every function here, plain or not,
pads the queries with zero columns to the slab's width.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .nn_query import l2_normalize, pad_columns, topk_lowest_index

Tensor = torch.Tensor

_TILE_N = 2048


def stack_codebooks(codebooks, tile_n: int = _TILE_N) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-object (N_i, D) codebooks into (O, N_pad, D), zero-padded
    to a multiple of `tile_n` rows. Returns (slab, lengths); queries MUST
    mask by `lengths` (a zero pad row's cosine 0 beats any all-negative
    true match)."""
    n_max = max(cb.shape[0] for cb in codebooks)
    n_pad = -(-n_max // tile_n) * tile_n
    d = codebooks[0].shape[1]
    out = np.zeros((len(codebooks), n_pad, d), np.float32)
    for i, cb in enumerate(codebooks):
        out[i, : cb.shape[0]] = cb
    lengths = np.asarray([cb.shape[0] for cb in codebooks], np.int32)
    return out, lengths


def pad_slab(slab: Tensor) -> Tensor:
    """The slab with zero columns up to the width the CUDA kernels take for
    its dtype (the slab itself when it has that width already): stored once,
    where the device copy is made, after `stack_codebooks`."""
    from ._cuda import stream_width

    return pad_columns(slab, stream_width(slab.shape[-1], slab.dtype))


def _queries(z: Tensor, codebooks: Tensor) -> Tensor:
    """The kernels' query operand: normalized in f32, cast to the slab
    dtype, zero columns up to the slab's width."""
    return pad_columns(l2_normalize(z.float()).to(codebooks.dtype), codebooks.shape[-1])


def _masked_cos(z: Tensor, codebooks: Tensor, obj_id: int, n_valid: int, stride: int = 1) -> Tensor:
    """(B, N_pad) f32 cosines against one plane: queries normalized in f32
    and cast to the slab dtype, products and sums in f32 (a bf16 slab is
    widened before the product), masked rows -2."""
    q = _queries(z, codebooks)
    cos = q.float() @ codebooks[obj_id].float().T
    col = torch.arange(cos.shape[1], device=cos.device)
    valid = col < n_valid
    if stride > 1:
        valid = valid & (col % stride == 0)
    return torch.where(valid[None, :], cos, torch.full_like(cos, -2.0))


def _n_valid(n_valid, codebooks: Tensor) -> int:
    return codebooks.shape[1] if n_valid is None else int(n_valid)


def _device_check(name: str, z: Tensor, codebooks: Tensor) -> bool:
    """True for the plain CPU path, False for the kernel; raises otherwise."""
    if z.device.type == "cpu" and codebooks.device.type == "cpu":
        return True
    if z.device.type == "cuda" and codebooks.device == z.device:
        return False
    raise ValueError(f"{name}: unsupported devices {z.device}, {codebooks.device}")


def grouped_codebook_top1_plain(
    z: Tensor, codebooks: Tensor, obj_id: int, n_valid: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    cos = _masked_cos(z, codebooks, int(obj_id), _n_valid(n_valid, codebooks))
    idcs = torch.argmax(cos, dim=1)
    vals = torch.gather(cos, 1, idcs[:, None])[:, 0]
    return vals, idcs.to(torch.int32)


def grouped_codebook_top1(
    z: Tensor, codebooks: Tensor, obj_id: int, n_valid: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """Top-1 for queries (B, D) that all share object `obj_id`.

    codebooks: (O, N_pad, D') f32 or bf16, rows l2-normalized, pad rows
    zero, D' >= the queries' width with zero columns beyond it (`pad_slab`).
    n_valid: this object's true length (None = N_pad). Returns
    (vals (B,) f32, idcs (B,) int32)."""
    if _device_check("grouped_codebook_top1", z, codebooks):
        return grouped_codebook_top1_plain(z, codebooks, obj_id, n_valid)
    from . import _cuda

    n_pad = codebooks.shape[1]
    vals, idcs = _cuda.codebook_top1_stream(
        _queries(z, codebooks).contiguous(), codebooks, int(obj_id), n_pad,
        _n_valid(n_valid, codebooks),
    )
    grouped_codebook_top1.launches += 1
    return vals, idcs


grouped_codebook_top1.launches = 0


def _check_k(k: int) -> None:
    if not 1 <= k <= 32:
        raise ValueError(
            f"grouped_codebook_topk supports 1 <= k <= 32 (got k={k}); "
            "use grouped_codebook_topk_plain for larger k"
        )


def grouped_codebook_topk_plain(
    z: Tensor,
    codebooks: Tensor,
    obj_id: int,
    n_valid: Optional[int] = None,
    *,
    k: int,
    stride: int = 1,
) -> Tuple[Tensor, Tensor]:
    cos = _masked_cos(z, codebooks, int(obj_id), _n_valid(n_valid, codebooks), stride)
    vals, idcs = topk_lowest_index(cos, k)
    return vals, idcs.to(torch.int32)


def grouped_codebook_topk(
    z: Tensor,
    codebooks: Tensor,
    obj_id: int,
    n_valid: Optional[int] = None,
    *,
    k: int,
    stride: int = 1,
) -> Tuple[Tensor, Tensor]:
    """Ranked top-k for queries sharing object `obj_id`, 1 <= k <= 32
    (ValueError otherwise, as in the JAX package). `stride` keeps only rows
    with index % stride == 0 (`upright`). Returns (vals (B, k) f32,
    idcs (B, k) int32), best first, ties to the lowest global index. The
    slab may hold zero columns beyond the queries' width (`pad_slab`); on
    CUDA its width must be a multiple of 16 in bf16 (tensor-core steps of 16
    columns) and of 4 in f32 (16-byte row copies), ValueError otherwise."""
    _check_k(k)
    if _device_check("grouped_codebook_topk", z, codebooks):
        return grouped_codebook_topk_plain(z, codebooks, obj_id, n_valid, k=k, stride=stride)
    from . import _cuda

    n_pad = codebooks.shape[1]
    vals, idcs = _cuda.codebook_topk_stream(
        _queries(z, codebooks).contiguous(), codebooks, int(obj_id), n_pad,
        _n_valid(n_valid, codebooks), int(stride), k,
    )
    grouped_codebook_topk.launches += 1
    return vals, idcs


grouped_codebook_topk.launches = 0


def multi_codebook_top1_plain(
    z: Tensor, codebooks: Tensor, obj_ids: Tensor, lengths: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Mixed-object top-1 by one gathered product (the JAX package's
    `multi_codebook_top1_xla`): each query dots only its own plane."""
    q = l2_normalize(z.float())
    obj_ids = obj_ids.long()
    cos = torch.einsum("bd,bnd->bn", q, codebooks[obj_ids].float())
    if lengths is not None:
        col = torch.arange(cos.shape[1], device=cos.device)[None, :]
        cos = torch.where(col < lengths.to(cos.device)[obj_ids][:, None], cos, torch.full_like(cos, -2.0))
    idcs = torch.argmax(cos, dim=1)
    vals = torch.gather(cos, 1, idcs[:, None])[:, 0]
    return vals, idcs.to(torch.int32)


def multi_codebook_top1(
    z: Tensor, codebooks: Tensor, obj_ids, lengths=None
) -> Tuple[Tensor, Tensor]:
    """Mixed-object top-1: the plain gathered product on CPU; on a GPU the
    queries are grouped by object on the host and each group runs
    `grouped_codebook_top1`."""
    obj_ids = torch.as_tensor(obj_ids)
    if z.device.type == "cpu":
        lengths_t = None if lengths is None else torch.as_tensor(lengths)
        return multi_codebook_top1_plain(z, codebooks, obj_ids, lengths_t)
    obj_np = obj_ids.cpu().numpy()
    vals = torch.empty((len(obj_np),), dtype=torch.float32, device=z.device)
    idcs = torch.empty((len(obj_np),), dtype=torch.int32, device=z.device)
    for obj in np.unique(obj_np):
        sel = torch.as_tensor(np.nonzero(obj_np == obj)[0], device=z.device)
        n_valid = None if lengths is None else int(np.asarray(lengths)[int(obj)])
        v, i = grouped_codebook_top1(z[sel], codebooks, int(obj), n_valid)
        vals[sel] = v
        idcs[sel] = i
    return vals, idcs
