"""ctypes binding + lazy build of the host C++ rasterizer (port of
augmentedautoencoder_tpu/renderer/native/binding.py).

On first use `rasterizer.cpp` is compiled with g++ (-O3 -march=native
-fopenmp, plain C ABI) into `build/aae_torch_host/<hash of source, flags
and CPU model>/`, beside the CUDA kernels' build directory (or under the
user cache where the package's parent is read-only, `utils.build_dirs`);
`build/` is not part of the checkout. A failed build raises with the compiler's output: there is
no silent fallback to the numpy rasterizer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ...utils.build_dirs import build_root
from ..mesh import Mesh

_SRC = Path(__file__).resolve().parent / "rasterizer.cpp"
BUILD_ROOT = build_root("aae_torch_host")
LIB_NAME = "librasterizer.so"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_model() -> bytes:
    """The host CPU's model line: -march=native code is only valid on its CPU."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            return next((line for line in fh if line.startswith(b"model name")), b"")
    except OSError:
        return b""


def build() -> Path:
    """Compile the rasterizer unless this source's library exists for this
    CPU; returns its path."""
    digest = hashlib.sha256(
        " ".join(CXX_FLAGS).encode() + _cpu_model() + _SRC.read_bytes()
    ).hexdigest()[:16]
    out_dir = BUILD_ROOT / digest
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as exc:
        raise RuntimeError("the native rasterizer needs g++ on PATH") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded rasterizer library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            dp, i32p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
            handle.aae_mesh_register.restype = ctypes.c_int
            handle.aae_mesh_register.argtypes = [
                dp, dp, dp, ctypes.c_int, i32p, ctypes.c_int,  # verts normals colors nv faces nf
            ]
            handle.aae_render.restype = ctypes.c_int
            handle.aae_render.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                dp, dp, dp,  # K R t
                ctypes.c_double, ctypes.c_double,  # near far
                dp,  # light_pos
                ctypes.c_double, ctypes.c_double, ctypes.c_double,  # phong
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_float),
                i32p,  # out px bbox (nullable)
            ]
            _lib = handle
        return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeRasterizer:
    """One registered mesh in the native backend. Registration is safe while
    other threads render (the library keeps meshes behind stable pointers)."""

    def __init__(self, mesh: Mesh):
        self._lib = lib()
        v = np.ascontiguousarray(mesh.vertices, dtype=np.float64)
        n = np.ascontiguousarray(mesh.normals, dtype=np.float64)
        f = np.ascontiguousarray(mesh.faces, dtype=np.int32)
        c = None if mesh.colors is None else np.ascontiguousarray(mesh.colors, dtype=np.float64)
        self._mesh_id = self._lib.aae_mesh_register(
            _dptr(v), _dptr(n), None if c is None else _dptr(c), len(v),
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(f),
        )
        if self._mesh_id < 0:
            raise RuntimeError(f"aae_mesh_register failed ({self._mesh_id})")

    def render(self, W, H, K, R, t, near, far, light_pos, ambient, diffuse, specular,
               return_px_bbox: bool = False):
        """(bgr uint8 (H, W, 3), depth float32 (H, W)), background zero; with
        return_px_bbox, (bgr, depth, px) where px is [min_x, min_y, max_x,
        max_y] (int32) of the depth > 0 pixels, or None when nothing is
        visible: the extent the rasterizer tracks as it writes, with no
        full-frame scan."""
        bgr = np.zeros((H, W, 3), dtype=np.uint8)
        depth = np.zeros((H, W), dtype=np.float32)
        px = np.empty(4, dtype=np.int32) if return_px_bbox else None
        K = np.ascontiguousarray(K, dtype=np.float64)
        R = np.ascontiguousarray(R, dtype=np.float64)
        t = np.ascontiguousarray(np.asarray(t).reshape(3), dtype=np.float64)
        lp = np.ascontiguousarray(np.asarray(light_pos).reshape(3), dtype=np.float64)
        rc = self._lib.aae_render(
            self._mesh_id, W, H, _dptr(K), _dptr(R), _dptr(t),
            float(near), float(far), _dptr(lp),
            float(ambient), float(diffuse), float(specular),
            bgr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            None if px is None else px.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:
            raise RuntimeError(f"native render failed (rc={rc})")
        if return_px_bbox:
            return bgr, depth, (None if px[2] < 0 else px)
        return bgr, depth
