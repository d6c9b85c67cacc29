"""Build and bind the port's hand-written CUDA kernels.

The sources are `augmentedautoencoder_torch/csrc/*.cu` (codebook_query.cu:
the codebook top-k; icp_nn.cu: the ICP nearest neighbour). On first use they
are compiled by `nvcc` for Hopper (sm_90a), one process per source, all
started together, and linked into one shared library with a plain C
interface under `build/aae_torch_kernels/<hash of the sources>/`. The
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
from pathlib import Path
from typing import Optional, Tuple

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "aae_torch_kernels"
LIB_NAME = "libaae_torch_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC"]

_TILE_ROWS = 256  # rows per block tile in csrc/codebook_query.cu
_MAX_D = 256
_MAX_K = 32

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
            handle.aae_codebook_topk.argtypes = [
                p, p, i32, i32, i64, i32, i32, i32, i32, i32, i32, i32, i32,
                p, p, p, p, p,
            ]
            handle.aae_codebook_topk.restype = i32
            handle.aae_batched_nn_min.argtypes = [p, p, i32, i32, p, p, p]
            handle.aae_batched_nn_min.restype = i32
            handle.aae_cuda_error_string.argtypes = [i32]
            handle.aae_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = lib().aae_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def codebook_topk(
    q: torch.Tensor,
    cb: torch.Tensor,
    obj: int,
    n_rows: int,
    n_valid: int,
    stride: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/codebook_query.cu on the current stream.

    q: (B, D) normalized queries, already in cb's dtype. cb: (N, D) or
    (O, N_pad, D), f32 or bf16, contiguous, on q's device. Scores rows
    [0, n_rows) of plane `obj`; rows >= n_valid, and rows not a multiple of
    `stride`, score -2. Returns (vals (B, k) f32, idcs (B, k) int32), best
    first, ties to the lowest index. Does not synchronise.
    """
    if q.device.type != "cuda" or cb.device != q.device:
        raise ValueError(f"codebook_topk needs CUDA tensors on one device, got {q.device}, {cb.device}")
    if cb.dtype not in (torch.float32, torch.bfloat16) or q.dtype != cb.dtype:
        raise ValueError(f"codebook_topk takes f32 or bf16 (q {q.dtype}, cb {cb.dtype})")
    if q.dim() != 2 or cb.dim() not in (2, 3) or q.shape[1] != cb.shape[-1]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} cb {tuple(cb.shape)}")
    if not (q.is_contiguous() and cb.is_contiguous()):
        raise ValueError("codebook_topk needs contiguous tensors")
    b, d = q.shape
    rows_per_obj = cb.shape[-2]
    n_obj = cb.shape[0] if cb.dim() == 3 else 1
    if not 0 <= obj < n_obj:
        raise ValueError(f"object {obj} outside the slab's {n_obj} planes")
    if not 1 <= n_rows <= rows_per_obj:
        raise ValueError(f"n_rows={n_rows} outside 1..{rows_per_obj}")
    if d > _MAX_D:
        raise ValueError(f"latent width {d} > {_MAX_D} is not supported by the kernel")
    if not 1 <= k <= min(_MAX_K, n_rows):
        raise ValueError(f"k={k} outside 1..min({_MAX_K}, {n_rows})")
    if b == 0:
        return (
            torch.empty((0, k), dtype=torch.float32, device=q.device),
            torch.empty((0, k), dtype=torch.int32, device=q.device),
        )

    # ~2 blocks per SM in flight over all query chunks; whole tiles per block
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    tiles = -(-n_rows // _TILE_ROWS)
    q_chunks = -(-b // 8)
    want = max(1, (2 * sms) // q_chunks)
    tiles_per_block = -(-tiles // min(tiles, want))
    n_parts = -(-tiles // tiles_per_block)

    part_v = torch.empty((b, n_parts, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, n_parts, k), dtype=torch.int32, device=q.device)
    out_v = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    rc = lib().aae_codebook_topk(
        q.data_ptr(), cb.data_ptr(), int(cb.dtype == torch.bfloat16), int(obj),
        int(rows_per_obj), int(n_rows), int(n_valid), int(stride), b, d, int(k),
        tiles_per_block * _TILE_ROWS, n_parts,
        part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check(rc, "aae_codebook_topk launch")
    return out_v, out_i


def batched_nn_min(src: torch.Tensor, dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/icp_nn.cu on the current stream.

    src: (n, N, 3) f32, the centred source points times -2; dst: (n, N, 4)
    f32 rows (x, y, z, |d|^2) of the centred destination points; both
    contiguous on one CUDA device. Returns (min (n, N) f32, argmin (n, N)
    int32) of ((sx*dx + sy*dy) + sz*dz) + |d|^2 over each lane's points,
    ties to the lowest index. Does not synchronise.
    """
    if src.device.type != "cuda" or dst.device != src.device:
        raise ValueError(f"batched_nn_min needs CUDA tensors on one device, got {src.device}, {dst.device}")
    if src.dtype != torch.float32 or dst.dtype != torch.float32:
        raise ValueError(f"batched_nn_min takes f32 (src {src.dtype}, dst {dst.dtype})")
    if src.dim() != 3 or src.shape[2] != 3 or dst.shape != (src.shape[0], src.shape[1], 4):
        raise ValueError(f"bad shapes src {tuple(src.shape)} dst {tuple(dst.shape)}")
    if not (src.is_contiguous() and dst.is_contiguous()) or dst.data_ptr() % 16:
        raise ValueError("batched_nn_min needs contiguous tensors and a 16-byte aligned dst")
    n, N = src.shape[0], src.shape[1]
    out_min = torch.empty((n, N), dtype=torch.float32, device=src.device)
    out_idx = torch.empty((n, N), dtype=torch.int32, device=src.device)
    if n == 0 or N == 0:
        return out_min, out_idx
    rc = lib().aae_batched_nn_min(
        src.data_ptr(), dst.data_ptr(), n, N, out_min.data_ptr(), out_idx.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    _check(rc, "aae_batched_nn_min launch")
    return out_min, out_idx
