"""Renderer facade over the software rasterizers (port of
augmentedautoencoder_tpu/renderer/facade.py, the part serving uses).

API mirrors auto_pose/meshrenderer/meshrenderer_phong.py:101-168:
  render(obj_id, W, H, K, R, t, near, far, random_light, phong) -> (bgr, depth)

Light sampling semantics are the JAX package's (meshrenderer_phong.py:117-129):
random_light: position = 1000*U(0,1)^3, diffuse/specular weights jittered by
+-0.1; fixed light at (400, 400, 400) with the nominal weights.

The backend is named, never guessed: "native" is the host C++ rasterizer
(renderer/native, built with g++ on first use; a failed build raises),
"numpy" the reference rasterizer the CPU tests compare it with.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import raster_numpy
from .mesh import Mesh, load_mesh

DEFAULT_PHONG = {"ambient": 0.4, "diffuse": 0.8, "specular": 0.3}
FIXED_LIGHT = np.array([400.0, 400.0, 400.0])


class Renderer:
    """Multi-object offscreen renderer on the host (vertex-colored Phong)."""

    def __init__(
        self,
        models_files: Sequence[str],
        vertex_scale: float = 1.0,
        backend: str = "native",
        meshes: Optional[Sequence[Mesh]] = None,
    ):
        if backend not in ("native", "numpy"):
            raise ValueError(f"backend must be 'native' or 'numpy', got {backend!r}")
        if meshes is not None:
            self._meshes = list(meshes)
        else:
            self._meshes = [load_mesh(p, vertex_scale=vertex_scale) for p in models_files]
        self._native = None
        if backend == "native":
            from .native import NativeRasterizer

            self._native = [NativeRasterizer(m) for m in self._meshes]

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "numpy"

    def _raster(self, obj_id, W, H, K, R, t, near, far, light_pos, ambient, diffuse, specular):
        if self._native is not None:
            return self._native[obj_id].render(
                W, H, K, R, t, near, far, light_pos, ambient, diffuse, specular
            )
        return raster_numpy.render_mesh(
            self._meshes[obj_id], W, H, K, R, t, near, far,
            light_pos, ambient, diffuse, specular,
        )

    @staticmethod
    def _sample_light(random_light: bool, phong: Dict[str, float]):
        if random_light:
            light_pos = 1000.0 * np.random.random(3)
            diffuse = phong["diffuse"] + 0.1 * (2 * np.random.rand() - 1)
            specular = phong["specular"] + 0.1 * (2 * np.random.rand() - 1)
            return light_pos, phong["ambient"], diffuse, specular
        return FIXED_LIGHT, phong["ambient"], phong["diffuse"], phong["specular"]

    def render(
        self,
        obj_id: int,
        W: int,
        H: int,
        K: np.ndarray,
        R: np.ndarray,
        t: np.ndarray,
        near: float,
        far: float,
        random_light: bool = False,
        phong: Dict[str, float] = DEFAULT_PHONG,
    ) -> Tuple[np.ndarray, np.ndarray]:
        light_pos, ambient, diffuse, specular = self._sample_light(random_light, phong)
        return self._raster(
            obj_id, int(W), int(H), K, R, t, near, far, light_pos, ambient, diffuse, specular
        )
