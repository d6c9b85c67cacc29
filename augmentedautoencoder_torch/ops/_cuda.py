"""Build and bind the port's hand-written CUDA kernels.

The sources are `augmentedautoencoder_torch/csrc/*.cu` (codebook_query.cu:
the codebook top-1 and top-k; icp_nn.cu: the ICP nearest neighbour). On
first use they are compiled by `nvcc` for Hopper (sm_90a), one process per
source, all started together, and linked into one shared library with a
plain C interface under `build/aae_torch_kernels/<hash of the sources>/`
(or under the user cache where the package's parent is read-only,
`utils.build_dirs`). The
library is loaded with `ctypes`; nothing includes PyTorch's headers, so a
build takes seconds. Nothing here runs at import time: the CPU tests import
every module of the port on a machine without `nvcc` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.build_dirs import build_root

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = build_root("aae_torch_kernels")
LIB_NAME = "libaae_torch_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC"]

_MAX_D = 256
_MAX_K = 32

# aae_codebook_topk_stream (csrc/codebook_query.cu)
STREAM_Q = 64  # queries per block at most (kStreamQ)
STREAM_MIN_ROWS = 16  # the bf16 mma's row step: tiles are a multiple of it
STREAM_BLOCKS_PER_SM = 2
_STREAM_TILE_BYTES = 16384  # row bytes per pipeline stage, about
_STREAM_MAX_STAGES = 4

# aae_codebook_top1_stream (csrc/codebook_query.cu)
TOP1_Q = 64  # queries per block at most (kTop1MaxQ)
TOP1_PAIRS = 16  # running (value, index) pairs a thread keeps (kTop1Pairs)
_TOP1_TILE_BYTES = 32768  # row bytes per pipeline stage, about
_THREADS = 256

# aae_batched_nn (csrc/icp_nn.cu)
NN_SRC_PER_BLOCK = 1024  # kNnThreads * kPts
NN_BLOCKS_PER_SM = 4  # search blocks per SM the destination split aims at
_NN_MIN_SPLIT = 64
_NN_MAX_SPLIT = 2048  # destinations per block: a 32 KB float4 tile
_NN_MAX_N = 65535 * _NN_MAX_SPLIT

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: ptxas resource report of the last build (registers, shared memory, spills)
build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "augmentedautoencoder_torch build only where the CUDA toolkit is installed"
    )


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd) -> str:
    proc = subprocess.run(
        [str(c) for c in cmd], capture_output=True, text=True, check=False
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"{' '.join(map(str, cmd))} failed ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the kernels if the cached library for these sources is
    missing; returns the library's path."""
    global build_log
    srcs = _sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.{threading.get_ident()}"

    def compile_one(src: Path) -> Tuple[Path, str]:
        obj = out_dir / f"{src.stem}.{tag}.o"
        log = _run([nvcc, *NVCC_FLAGS, "--ptxas-options=-v", "-c", src, "-o", obj])
        return obj, log

    with ThreadPoolExecutor(len(srcs)) as pool:
        results = list(pool.map(compile_one, srcs))
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    _run([nvcc, *ARCH_FLAGS, "-shared", *[o for o, _ in results], "-o", tmp])
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    for obj, _ in results:
        obj.unlink()
    build_log = "".join(log for _, log in results)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            handle.aae_codebook_topk_stream.argtypes = [
                p, p, i32, i32, i64, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
                p, p, p, p, p,
            ]
            handle.aae_codebook_topk_stream.restype = i32
            handle.aae_codebook_top1_stream.argtypes = [
                p, p, i32, i32, i64, i32, i32, i32, i32, i32, i32, i32, i32, i32,
                p, p, p, p,
            ]
            handle.aae_codebook_top1_stream.restype = i32
            handle.aae_batched_nn.argtypes = [
                p, p, i32, i32, i32, ctypes.c_float, p, p, p, p, p, p, p,
            ]
            handle.aae_batched_nn.restype = i32
            handle.aae_device_smem.argtypes = [i32, p]
            handle.aae_device_smem.restype = i32
            handle.aae_cuda_error_string.argtypes = [i32]
            handle.aae_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = lib().aae_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


@lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


class SmemLimits(NamedTuple):
    """Shared memory of a CUDA device, in bytes."""

    per_sm: int
    per_block: int  # the most one block may opt in to
    reserved: int  # taken by the runtime in each block


@lru_cache(maxsize=None)
def smem_limits(device_index: int) -> SmemLimits:
    """The device's shared-memory limits, read once per device."""
    out = (ctypes.c_int * 3)()
    _check(lib().aae_device_smem(device_index, out), "aae_device_smem")
    return SmemLimits(*out)


def _check_topk_args(q, cb, obj, n_rows, k, name) -> int:
    """Shared argument checks of the codebook top-1 and top-k launches;
    returns the rows per plane."""
    if q.device.type != "cuda" or cb.device != q.device:
        raise ValueError(f"{name} needs CUDA tensors on one device, got {q.device}, {cb.device}")
    if cb.dtype not in (torch.float32, torch.bfloat16) or q.dtype != cb.dtype:
        raise ValueError(f"{name} takes f32 or bf16 (q {q.dtype}, cb {cb.dtype})")
    if q.dim() != 2 or cb.dim() not in (2, 3) or q.shape[1] != cb.shape[-1]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} cb {tuple(cb.shape)}")
    if not (q.is_contiguous() and cb.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
    rows_per_obj = cb.shape[-2]
    n_obj = cb.shape[0] if cb.dim() == 3 else 1
    if not 0 <= obj < n_obj:
        raise ValueError(f"object {obj} outside the slab's {n_obj} planes")
    if not 1 <= n_rows <= rows_per_obj:
        raise ValueError(f"n_rows={n_rows} outside 1..{rows_per_obj}")
    if q.shape[1] > _MAX_D:
        raise ValueError(f"latent width {q.shape[1]} > {_MAX_D} is not supported by the kernel")
    if not 1 <= k <= min(_MAX_K, n_rows):
        raise ValueError(f"k={k} outside 1..min({_MAX_K}, {n_rows})")
    return rows_per_obj


class StreamPlan(NamedTuple):
    """Launch shape of aae_codebook_topk_stream."""

    rows_per_tile: int
    stages: int
    n_blocks: int
    q_per_block: int
    smem_bytes: int
    scratch_words: int  # int32 words of one allocation: part_v, part_i, out_v, out_i


def _width_step(dtype: torch.dtype) -> int:
    return 16 if dtype == torch.bfloat16 else 4


def stream_width(d: int, dtype: torch.dtype) -> int:
    """The width, at least d, that the streaming kernels take for a `dtype`
    codebook: the callers store their device copy with zero columns up to it
    and pad the queries to match (zero columns add exact zeros to every
    score)."""
    step = _width_step(dtype)
    return -(-d // step) * step


def check_stream_width(d: int, dtype: torch.dtype) -> None:
    """The streaming kernels copy whole rows in 16-byte pieces, and a bf16
    slab is scored in tensor-core steps of 16 columns."""
    step = _width_step(dtype)
    if d % step:
        raise ValueError(
            f"the CUDA codebook queries need a latent width that is a multiple of {step} "
            f"for a {dtype} codebook (got {d}): rows are copied in 16-byte pieces"
            + (" and scored in tensor-core steps of 16 columns" if step == 16 else "")
        )


def stream_smem_bytes(stages: int, rows_per_tile: int, row_bytes: int, qb: int, d: int, k: int) -> int:
    """csrc/codebook_query.cu stream_smem_bytes: ring, queries, scores, lists."""
    qpad = -(-qb // 8) * 8
    return (stages * rows_per_tile * (row_bytes + 16) + qpad * (d + 8) * 4
            + qb * rows_per_tile * 4 + qb * k * 8)


@lru_cache(maxsize=None)
def plan_topk_stream(
    b: int, n_rows: int, d: int, elem_bytes: int, k: int, sms: int, smem: SmemLimits
) -> StreamPlan:
    """Tiles of whole rows of ~16 KB (a multiple of 32 rows) and up to
    STREAM_Q queries per block, with as many ring stages (2-4) as fit
    STREAM_BLOCKS_PER_SM blocks in an SM's shared memory; a persistent grid
    of STREAM_BLOCKS_PER_SM * sms blocks per chunk of queries, never more
    blocks than tiles. Where 2 stages do not fit (a wide latent with many
    queries and a large k), the tiles halve down to STREAM_MIN_ROWS rows,
    then the blocks take half as many queries (more chunks), as the top-1
    plan does; ValueError only if one query of 16-row tiles does not fit."""
    row_bytes = d * elem_bytes
    budget = min(smem.per_block, smem.per_sm // STREAM_BLOCKS_PER_SM - smem.reserved)
    qpb = min(b, STREAM_Q)
    while True:
        rows = max(32, (_STREAM_TILE_BYTES // row_bytes) // 32 * 32)
        while True:
            fixed = stream_smem_bytes(0, rows, row_bytes, qpb, d, k)
            stages = min(_STREAM_MAX_STAGES, (budget - fixed) // (rows * (row_bytes + 16)))
            if stages >= 2:
                n_blocks = min(-(-n_rows // rows), STREAM_BLOCKS_PER_SM * sms)
                scratch = 2 * b * n_blocks * k + 2 * b * k
                return StreamPlan(rows, stages, n_blocks, qpb,
                                  stream_smem_bytes(stages, rows, row_bytes, qpb, d, k), scratch)
            if rows == STREAM_MIN_ROWS:
                break
            rows = max(STREAM_MIN_ROWS, rows // 2)
        if qpb == 1:
            raise ValueError(
                f"grouped_codebook_topk on CUDA: no 2-stage pipeline of {STREAM_BLOCKS_PER_SM} blocks "
                f"per SM fits {budget} bytes of shared memory for one query of width {d}, k={k}"
            )
        qpb = max(1, qpb // 2)


def codebook_topk_stream(
    q: torch.Tensor,
    cb: torch.Tensor,
    obj: int,
    n_rows: int,
    n_valid: int,
    stride: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the streaming top-k of csrc/codebook_query.cu on the current
    stream (grouped_codebook_topk).

    q: (B, D) normalized queries, already in cb's dtype. cb: (N, D) or
    (O, N_pad, D), f32 or bf16, contiguous, 16-byte aligned, on q's device;
    D a multiple of 4 (f32) or 16 (bf16), see `stream_width`. Scores rows
    [0, n_rows) of plane `obj`; rows >= n_valid, and rows not a multiple of
    `stride`, score -2. Returns (vals (B, k) f32, idcs (B, k) int32), best
    first, ties to the lowest index. One allocation (outputs and scratch);
    does not synchronise."""
    rows_per_obj = _check_topk_args(q, cb, obj, n_rows, k, "codebook_topk_stream")
    b, d = q.shape
    check_stream_width(d, cb.dtype)
    if cb.data_ptr() % 16:
        raise ValueError("codebook_topk_stream needs a 16-byte aligned codebook")
    if b == 0:
        return (
            torch.empty((0, k), dtype=torch.float32, device=q.device),
            torch.empty((0, k), dtype=torch.int32, device=q.device),
        )
    dev = q.device.index
    plan = plan_topk_stream(b, n_rows, d, cb.element_size(), k, sm_count(dev), smem_limits(dev))
    buf = torch.empty((plan.scratch_words,), dtype=torch.int32, device=q.device)
    base, part = buf.data_ptr(), b * plan.n_blocks * k
    rc = lib().aae_codebook_topk_stream(
        q.data_ptr(), cb.data_ptr(), int(cb.dtype == torch.bfloat16), int(obj),
        int(rows_per_obj), int(n_rows), int(n_valid), int(stride), b, d, int(k),
        plan.q_per_block, plan.rows_per_tile, plan.stages, plan.n_blocks,
        base, base + 4 * part, base + 8 * part, base + 8 * part + 4 * b * k,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check(rc, "aae_codebook_topk_stream launch")
    out = buf[2 * part:].view(2, b, k)
    return out[0].view(torch.float32), out[1]


class Top1Plan(NamedTuple):
    """Launch shape of aae_codebook_top1_stream."""

    rows_per_tile: int
    stages: int
    n_blocks: int
    q_per_block: int
    qpt: int  # queries per f32 scoring item (2 or 8)
    smem_bytes: int


def top1_smem_bytes(stages: int, rows_per_tile: int, row_bytes: int, qpb: int, d: int) -> int:
    """csrc/codebook_query.cu top1_smem_bytes: ring, queries, one key per query."""
    qpad = -(-qpb // 8) * 8
    return stages * rows_per_tile * (row_bytes + 16) + qpad * (d + 8) * 4 + qpb * 8


def _top1_rows_cap(qpb: int, qpt: int, elem_bytes: int) -> int:
    """The most rows per tile for which a thread keeps at most TOP1_PAIRS
    running pairs: f32 items are one row x qpt queries, `_THREADS` to a
    pass; bf16 items are 16 rows x 8 queries, one per warp and pass."""
    if elem_bytes == 2:
        return (TOP1_PAIRS // 2) * (_THREADS // 32) * 16 // -(-qpb // 8) // 32 * 32
    return (TOP1_PAIRS // qpt) * _THREADS // -(-qpb // qpt) // 32 * 32


@lru_cache(maxsize=None)
def plan_top1_stream(b: int, n_rows: int, d: int, elem_bytes: int, sms: int, smem: SmemLimits) -> Top1Plan:
    """Tiles of whole rows of ~32 KB (a multiple of 32 rows, capped so that
    a thread keeps at most TOP1_PAIRS running pairs) and up to 64 queries per
    block, with as many ring stages (2-4) as fit STREAM_BLOCKS_PER_SM blocks
    in an SM's shared memory; a persistent grid of STREAM_BLOCKS_PER_SM * sms
    blocks per chunk of queries, never more blocks than tiles. Where 2
    stages do not fit, the tiles shrink to 32 rows, then the blocks take
    fewer queries (down to 8, halving); ValueError only if 8 queries of
    32-row tiles do not fit."""
    row_bytes = d * elem_bytes
    budget = min(smem.per_block, smem.per_sm // STREAM_BLOCKS_PER_SM - smem.reserved)
    qpb = min(b, TOP1_Q)
    while True:
        qpt = 2 if qpb <= 8 else 8
        rows = max(32, min((_TOP1_TILE_BYTES // row_bytes) // 32 * 32, _top1_rows_cap(qpb, qpt, elem_bytes)))
        while True:
            stages = min(_STREAM_MAX_STAGES,
                         (budget - top1_smem_bytes(0, rows, row_bytes, qpb, d)) // (rows * (row_bytes + 16)))
            if stages >= 2:
                n_blocks = min(-(-n_rows // rows), STREAM_BLOCKS_PER_SM * sms)
                return Top1Plan(rows, stages, n_blocks, qpb, qpt,
                                top1_smem_bytes(stages, rows, row_bytes, qpb, d))
            if rows == 32:
                break
            rows = max(32, rows // 2 // 32 * 32)
        if qpb <= 8:
            raise ValueError(
                f"codebook top-1 on CUDA: no 2-stage pipeline of {STREAM_BLOCKS_PER_SM} blocks per SM "
                f"fits {budget} bytes of shared memory for {qpb} queries of width {d}"
            )
        qpb = max(8, qpb // 2)


_top1_state = {}  # (device index, stream handle) -> int64 words, 0 between launches


def _top1_state_words(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The top-1 kernel's state for launches on `stream`: one 64-bit key per
    query and one arrival counter per query chunk, zeroed once (the only
    device operation besides the launch, on a stream's first call or when a
    call needs more words) and left 0 by every launch. Launches on one
    stream run in order, so they share it safely."""
    key = (device.index, stream)
    buf = _top1_state.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 256),), dtype=torch.int64, device=device)
        _top1_state[key] = buf
    return buf


def codebook_top1_stream(
    q: torch.Tensor, cb: torch.Tensor, obj: int, n_rows: int, n_valid: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the streaming top-1 of csrc/codebook_query.cu on the current
    stream (grouped_codebook_top1 and cosine_top1_cuda).

    q: (B, D) normalized queries, already in cb's dtype. cb: (N, D) or
    (O, N_pad, D), f32 or bf16, contiguous, 16-byte aligned, on q's device;
    D a multiple of 4 (f32) or 16 (bf16), see `stream_width`. Scores rows
    [0, n_rows) of plane `obj`; rows >= n_valid score -2. Returns (vals (B,)
    f32, idcs (B,) int32): the first maximum. One allocation (the outputs),
    one launch; does not synchronise."""
    rows_per_obj = _check_topk_args(q, cb, obj, n_rows, 1, "codebook_top1_stream")
    b, d = q.shape
    check_stream_width(d, cb.dtype)
    if cb.data_ptr() % 16:
        raise ValueError("codebook_top1_stream needs a 16-byte aligned codebook")
    if b == 0:
        return (torch.empty((0,), dtype=torch.float32, device=q.device),
                torch.empty((0,), dtype=torch.int32, device=q.device))
    dev = q.device.index
    plan = plan_top1_stream(b, n_rows, d, cb.element_size(), sm_count(dev), smem_limits(dev))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    state = _top1_state_words(q.device, stream, b + -(-b // plan.q_per_block))
    out = torch.empty((2, b), dtype=torch.int32, device=q.device)
    rc = lib().aae_codebook_top1_stream(
        q.data_ptr(), cb.data_ptr(), int(cb.dtype == torch.bfloat16), int(obj),
        int(rows_per_obj), int(n_rows), int(n_valid), b, d, plan.q_per_block, plan.qpt,
        plan.rows_per_tile, plan.stages, plan.n_blocks,
        state.data_ptr(), out.data_ptr(), out.data_ptr() + 4 * b, stream,
    )
    _check(rc, "aae_codebook_top1_stream launch")
    return out[0].view(torch.float32), out[1]


@lru_cache(maxsize=None)
def plan_nn(n: int, N: int, sms: int) -> Tuple[int, int]:
    """(split_len, n_splits) of aae_batched_nn: each lane's destinations are
    cut into n_splits runs of split_len (the last one shorter), so that
    n * ceil(N / 1024) * n_splits blocks come near NN_BLOCKS_PER_SM * sms
    (4 blocks of 256 threads at 64 registers a thread fill an SM's
    registers), with runs of at most 2048 points and no more than
    ceil(N / 64) runs."""
    src_blocks = -(-N // NN_SRC_PER_BLOCK)
    want = -(-NN_BLOCKS_PER_SM * sms // (n * src_blocks))
    splits = max(1, min(want, -(-N // _NN_MIN_SPLIT)))
    split_len = min(-(-N // splits), _NN_MAX_SPLIT)
    return split_len, -(-N // split_len)


def batched_nn(src: torch.Tensor, dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/icp_nn.cu aae_batched_nn on the current stream.

    src, dst: (n, N, 3) f32 clouds, contiguous, on one CUDA device.
    Returns (dist (n, N) f32, idx (n, N) int32): batched_nn_torch's
    function, bit for bit. One allocation (outputs and scratch), two
    launches (nn_prep_kernel, nn_search_kernel); does not synchronise.
    """
    from .icp_nn import recip_f32

    if src.device.type != "cuda" or dst.device != src.device:
        raise ValueError(f"batched_nn needs CUDA tensors on one device, got {src.device}, {dst.device}")
    if src.dtype != torch.float32 or dst.dtype != torch.float32:
        raise ValueError(f"batched_nn takes f32 (src {src.dtype}, dst {dst.dtype})")
    if src.dim() != 3 or src.shape[2] != 3 or dst.shape != src.shape:
        raise ValueError(f"bad shapes src {tuple(src.shape)} dst {tuple(dst.shape)}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("batched_nn needs contiguous tensors")
    n, N = src.shape[0], src.shape[1]
    if n > 65535 or N > _NN_MAX_N:
        raise ValueError(f"batched_nn takes up to 65535 lanes of {_NN_MAX_N} points, got ({n}, {N})")
    if n == 0 or N == 0:
        return (torch.empty((n, N), dtype=torch.float32, device=src.device),
                torch.empty((n, N), dtype=torch.int32, device=src.device))
    split_len, _ = plan_nn(n, N, sm_count(src.device.index))
    nN, src_blocks = n * N, -(-N // NN_SRC_PER_BLOCK)
    # int32 words: rows (4 nN), keys (2 nN), dist, idx, mu (3 n), arrivals
    buf = torch.empty((8 * nN + 3 * n + n * src_blocks,), dtype=torch.int32, device=src.device)
    base = buf.data_ptr()
    rc = lib().aae_batched_nn(
        src.data_ptr(), dst.data_ptr(), n, N, split_len, recip_f32(N),
        base, base + 16 * nN, base + 32 * nN, base + 32 * nN + 12 * n, base + 24 * nN, base + 28 * nN,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    _check(rc, "aae_batched_nn launch")
    out = buf[6 * nN: 8 * nN].view(2, n, N)
    return out[0].view(torch.float32), out[1]
