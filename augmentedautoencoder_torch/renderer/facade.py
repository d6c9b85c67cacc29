"""Renderer facade over the software rasterizers (port of
augmentedautoencoder_tpu/renderer/facade.py).

API mirrors auto_pose/meshrenderer/meshrenderer_phong.py:101-224:
  render(obj_id, W, H, K, R, t, near, far, random_light, phong) -> (bgr, depth)
  render_with_bbox(...) -> (bgr, depth, obj_bb or None)
  render_many(obj_ids, ...) -> (bgr, depth, bbs)
  render_normals(...) -> (bgr, depth, normals)

Light sampling semantics are the JAX package's (meshrenderer_phong.py:117-129):
random_light: position = 1000*U(0,1)^3, diffuse/specular weights jittered by
+-0.1; fixed light at (400, 400, 400) with the nominal weights.

`samples > 1` renders color at 2x and box-downsamples it (uint16 mean);
depth is always rendered at 1x (the reference's MSAA path also resolves
only the color attachment and re-renders depth without MSAA,
meshrenderer_phong.py:148-158).

The backend is named, never guessed: "native" is the host C++ rasterizer
(renderer/native, built with g++ on first use; a failed build raises),
"numpy" the reference rasterizer the CPU tests compare it with. Unlike the
JAX package, no mesh cache is written unless `vertex_tmp_store_folder`
names a directory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..geometry.view_sampler import calc_2d_bbox
from . import raster_numpy
from .mesh import Mesh, decimate_mesh, load_mesh

DEFAULT_PHONG = {"ambient": 0.4, "diffuse": 0.8, "specular": 0.3}
FIXED_LIGHT = np.array([400.0, 400.0, 400.0])

#: cad_shader.frag's fixed gray-beige material (cad_shader.frag:22-24)
CAD_MATERIAL = np.array([223.0, 214.0, 205.0])


class Renderer:
    """Multi-object offscreen renderer on the host.

    shading='vertex' is the reconst path (per-vertex colors, positional
    light, full Phong -- depth_shader_phong). shading='cad' reproduces the
    reference cad renderer's effective behavior including its uniform-
    location mismatch (meshrenderer.py:88-98 writes ambient/light/diffuse/
    specular to locations 0..3 while cad_shader.frag reads light at 0,
    ambient at 2, diffuse at 3, specular at 4): the light sits at the
    camera origin, the configured DIFFUSE weight acts as ambient, the
    SPECULAR weight acts as diffuse, and specular is zero. Reference cad
    codebooks were built with exactly this shading, so parity requires it.
    """

    def __init__(
        self,
        models_files: Sequence[str],
        samples: int = 1,
        vertex_tmp_store_folder: Optional[str] = None,
        vertex_scale: float = 1.0,
        backend: str = "native",
        meshes: Optional[Sequence[Mesh]] = None,
        shading: str = "vertex",
        max_faces: Optional[int] = None,
    ):
        if backend not in ("native", "numpy"):
            raise ValueError(f"backend must be 'native' or 'numpy', got {backend!r}")
        if shading not in ("vertex", "cad"):
            raise ValueError(f"shading must be 'vertex' or 'cad', got {shading!r}")
        self._samples = int(samples)
        self._shading = shading
        if meshes is not None:
            self._meshes = list(meshes)
        else:
            self._meshes = [
                load_mesh(p, vertex_scale=vertex_scale, cache_dir=vertex_tmp_store_folder)
                for p in models_files
            ]
        if max_faces:
            # LOD for the offline renders: sub-pixel triangles cost per-face
            # setup, and clustering to <= max_faces cuts it
            self._meshes = [decimate_mesh(m, max_faces) for m in self._meshes]
        if shading == "cad":
            self._meshes = [
                dataclasses.replace(m, colors=np.tile(CAD_MATERIAL, (len(m.vertices), 1)))
                for m in self._meshes
            ]
        self._native = None
        if backend == "native":
            from .native import NativeRasterizer

            self._native = [NativeRasterizer(m) for m in self._meshes]

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "numpy"

    # ------------------------------------------------------------------
    def _raster(self, obj_id, W, H, K, R, t, near, far, light_pos, ambient, diffuse, specular):
        if self._native is not None:
            return self._native[obj_id].render(
                W, H, K, R, t, near, far, light_pos, ambient, diffuse, specular
            )
        return raster_numpy.render_mesh(
            self._meshes[obj_id], W, H, K, R, t, near, far,
            light_pos, ambient, diffuse, specular,
        )

    def sample_light(self, random_light: bool, phong: Dict[str, float] = DEFAULT_PHONG, rng=None):
        """(light_pos, ambient, diffuse, specular) of one render, as
        `render(..., light=...)` takes it. A random light draws from `rng`
        (an np.random.RandomState; the global np.random when None), in the
        order the JAX package draws it: position, [cad: ambient], diffuse,
        specular."""
        if random_light:
            rng = np.random if rng is None else rng
            light_pos = 1000.0 * rng.random_sample(3)
            if self._shading == "cad":
                # the cad renderer also jitters ambient (meshrenderer.py:99)
                ambient = phong["ambient"] + 0.1 * (2 * rng.rand() - 1)
            else:
                ambient = phong["ambient"]
            diffuse = phong["diffuse"] + 0.1 * (2 * rng.rand() - 1)
            specular = phong["specular"] + 0.1 * (2 * rng.rand() - 1)
        else:
            light_pos = FIXED_LIGHT
            ambient = phong["ambient"]
            diffuse = phong["diffuse"]
            specular = phong["specular"]
        if self._shading == "cad":
            # uniform-location mismatch (see the class docstring): light at
            # the camera origin; diffuse weight -> ambient, specular -> diffuse
            light_pos = np.zeros(3)
            ambient, diffuse, specular = diffuse, specular, 0.0
        return light_pos, ambient, diffuse, specular

    def _render_one(self, obj_id, W, H, K, R, t, near, far, light):
        light_pos, ambient, diffuse, specular = light
        W, H = int(W), int(H)
        if self._samples > 1:
            K2 = np.asarray(K, dtype=np.float64).copy()
            K2[:2, :] *= 2.0
            bgr2, _ = self._raster(
                obj_id, 2 * W, 2 * H, K2, R, t, near, far,
                light_pos, ambient, diffuse, specular,
            )
            bgr = (
                bgr2.reshape(H, 2, W, 2, 3).astype(np.uint16).mean(axis=(1, 3))
            ).astype(np.uint8)
            _, depth = self._raster(
                obj_id, W, H, K, R, t, near, far, light_pos, ambient, diffuse, specular,
            )
            return bgr, depth
        return self._raster(obj_id, W, H, K, R, t, near, far, light_pos, ambient, diffuse, specular)

    # ------------------------------------------------------------------
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
        light: Optional[tuple] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """`light` (from `sample_light`) overrides random_light and phong."""
        if light is None:
            light = self.sample_light(random_light, phong)
        return self._render_one(obj_id, W, H, K, R, t, near, far, light)

    def render_with_bbox(
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
        light: Optional[tuple] = None,
    ) -> Tuple[np.ndarray, np.ndarray, Optional[List[float]]]:
        """(bgr, depth, obj_bb) where obj_bb equals calc_2d_bbox(nonzero(depth))
        (None when nothing is visible). On the native backend at one sample
        the visible-pixel extent comes from the rasterizer, with no
        full-frame scan. `light` (from `sample_light`) overrides
        random_light and phong."""
        if light is None:
            light = self.sample_light(random_light, phong)
        W, H = int(W), int(H)
        if self._native is not None and self._samples <= 1:
            light_pos, ambient, diffuse, specular = light
            bgr, depth, px = self._native[obj_id].render(
                W, H, K, R, t, near, far, light_pos, ambient, diffuse, specular,
                return_px_bbox=True,
            )
            if px is None:
                return bgr, depth, None
            # calc_2d_bbox semantics from the extents (view_sampler.calc_2d_bbox)
            tlx = max(int(px[0]) - 1, 0)
            tly = max(int(px[1]) - 1, 0)
            brx = min(int(px[2]) + 1, W - 1)
            bry = min(int(px[3]) + 1, H - 1)
            return bgr, depth, [tlx, tly, brx - tlx, bry - tly]
        bgr, depth = self._render_one(obj_id, W, H, K, R, t, near, far, light)
        ys, xs = np.nonzero(depth > 0)
        if len(xs) == 0:
            return bgr, depth, None
        return bgr, depth, calc_2d_bbox(xs, ys, (W, H))

    def render_many(
        self,
        obj_ids: Sequence[int],
        W: int,
        H: int,
        K: np.ndarray,
        Rs: Sequence[np.ndarray],
        ts: Sequence[np.ndarray],
        near: float,
        far: float,
        random_light: bool = True,
        phong: Dict[str, float] = DEFAULT_PHONG,
    ) -> Tuple[np.ndarray, np.ndarray, List[List[float]]]:
        """Composite several objects into one scene by depth; per-object
        boxes from their own depth passes (meshrenderer_phong.py:170-224).

        Light is sampled once for the whole scene; in the random case the
        ambient weight is jittered too (meshrenderer_phong.py:178)."""
        if random_light:
            light_pos = 1000.0 * np.random.random(3)
            ambient = phong["ambient"] + 0.1 * (2 * np.random.rand() - 1)
            diffuse = phong["diffuse"] + 0.1 * (2 * np.random.rand() - 1)
            specular = phong["specular"] + 0.1 * (2 * np.random.rand() - 1)
        else:
            light_pos = FIXED_LIGHT
            ambient = phong["ambient"]
            diffuse = phong["diffuse"]
            specular = phong["specular"]
        light = (light_pos, ambient, diffuse, specular)

        scene_bgr = np.zeros((H, W, 3), dtype=np.uint8)
        scene_depth = np.zeros((H, W), dtype=np.float32)
        bbs = []
        for obj_id, R, t in zip(obj_ids, Rs, ts):
            bgr, depth = self._render_one(obj_id, W, H, K, R, t, near, far, light)
            ys, xs = np.nonzero(depth > 0)
            bbs.append(calc_2d_bbox(xs, ys, (W, H)))
            closer = (depth > 0) & ((scene_depth == 0) | (depth < scene_depth))
            scene_depth[closer] = depth[closer]
            scene_bgr[closer] = bgr[closer]
        return scene_bgr, scene_depth, bbs

    def render_normals(
        self,
        obj_id: int,
        W: int,
        H: int,
        K: np.ndarray,
        R: np.ndarray,
        t: np.ndarray,
        near: float,
        far: float,
        phong: Dict[str, float] = DEFAULT_PHONG,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(bgr, depth, normals) with camera-space normals as n*0.5+0.5 (the
        meshrenderer_phong_normals variant's third color attachment), drawn
        by the numpy rasterizer on either backend, as the JAX package does."""
        return raster_numpy.render_mesh(
            self._meshes[obj_id], int(W), int(H), K, R, t, near, far,
            FIXED_LIGHT, phong["ambient"], phong["diffuse"], phong["specular"],
            return_normals=True,
        )
