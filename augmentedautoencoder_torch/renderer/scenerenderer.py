"""Cluttered multi-object scene generator for detector training data (port
of augmentedautoencoder_tpu/renderer/scenerenderer.py; reference
auto_pose/meshrenderer/scenerenderer.py).

N objects at triangular-distributed depths and uniform in-frustum x/y
(rejecting near-collinear placements), random rotations, random light,
background compositing through the depth mask, optional host-side
augmentation, and per-object pixel boxes. Every random number comes from
the global `np.random` in the JAX package's order, so the same seed gives
the same scenes. Backgrounds are decoded with PIL and resized by
`pose.estimator.resize_linear_u8` (cv2.imread and cv2.resize's pixels).
"""

from __future__ import annotations

import glob
import math
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..geometry import transform, view_sampler
from .facade import Renderer
from .mesh import Mesh


class SceneRenderer:
    def __init__(
        self,
        models_cad_files: Sequence[str],
        vertex_tmp_store_folder: str,
        vertex_scale: float,
        width: int,
        height: int,
        K: np.ndarray,
        augmenters: Optional[Callable[[np.ndarray], np.ndarray]],
        vocdevkit_path: str,
        min_num_objects_per_scene: int,
        max_num_objects_per_scene: int,
        near_plane: float = 10.0,
        far_plane: float = 2000.0,
        min_n_views: int = 1000,
        radius: float = 650.0,
        obj_ids: Optional[Sequence[int]] = None,
        model_type: str = "reconst",
        renderer: Optional[Renderer] = None,
        meshes: Optional[Sequence[Mesh]] = None,
    ):
        self._width = width
        self._height = height
        self._radius = radius
        self._K = np.asarray(K, dtype=np.float64)
        self._augmenters = augmenters
        self._min_n = min_num_objects_per_scene
        self._max_n = max_num_objects_per_scene
        self._near = near_plane
        self._far = far_plane
        n_models = len(models_cad_files) if meshes is None else len(meshes)
        self.obj_ids = np.asarray(obj_ids if obj_ids is not None else range(n_models))
        self._n_models = n_models

        self._voc_imgs = sorted(
            glob.glob(os.path.join(vocdevkit_path, "*.jpg"))
            + glob.glob(os.path.join(vocdevkit_path, "*.png"))
        )

        self._renderer = renderer or Renderer(
            models_cad_files,
            samples=1,
            vertex_tmp_store_folder=vertex_tmp_store_folder,
            vertex_scale=vertex_scale,
            meshes=meshes,
        )

        views, _ = view_sampler.sample_views(
            min_n_views, radius, (0, 2 * math.pi), (-0.5 * math.pi, 0.5 * math.pi)
        )
        self.all_view_Rs = np.array([v["R"] for v in views])

    def _sample_placements(self, n: int):
        """Triangular depth + uniform frustum x/y; reject placements whose
        view rays are within ~8 degrees of an existing object."""
        ts: List[np.ndarray] = []
        ts_norm: List[np.ndarray] = []
        Rs: List[np.ndarray] = []
        for _ in range(n):
            while True:
                tz = np.random.triangular(
                    self._radius - self._radius / 3,
                    self._radius,
                    self._radius + self._radius / 3,
                )
                tx = np.random.uniform(
                    -0.35 * tz * self._width / self._K[0, 0],
                    0.35 * tz * self._width / self._K[0, 0],
                )
                ty = np.random.uniform(
                    -0.35 * tz * self._height / self._K[1, 1],
                    0.35 * tz * self._height / self._K[1, 1],
                )
                t = np.array([tx, ty, tz])
                t_norm = t / np.linalg.norm(t)
                if ts_norm and np.any(np.asarray(ts_norm) @ t_norm > 0.99):
                    continue
                ts_norm.append(t_norm)
                ts.append(t)
                Rs.append(transform.random_rotation_matrix()[:3, :3])
                break
        return Rs, ts

    def render(self) -> Tuple[np.ndarray, List[dict]]:
        """One scene: returns (bgr uint8 (H,W,3), [{'id', 'bb': xyxy}])."""
        from ..data.dataset import decode_bgr
        from ..pose.estimator import resize_linear_u8

        if self._min_n == self._max_n:
            n = self._min_n
        else:
            n = np.random.randint(self._min_n, self._max_n)
        obj_is = np.random.choice(self._n_models, n)
        # random full rotations like the reference (it overwrites the
        # sampled view R with a random rotation, scenerenderer.py:99)
        Rs, ts = self._sample_placements(n)

        bgr, depth, bbs = self._renderer.render_many(
            obj_is, self._width, self._height, self._K.copy(), Rs, ts,
            self._near, self._far, random_light=True,
        )

        if self._voc_imgs:
            bg = decode_bgr(self._voc_imgs[np.random.randint(len(self._voc_imgs))])
            bg = resize_linear_u8(bg, (self._width, self._height))
        else:
            bg = np.zeros((self._height, self._width, 3), np.uint8)
        mask = depth[..., None] > 0
        out = np.where(mask, bgr, bg)

        obj_info = []
        for (x, y, w, h), obj_id in zip(bbs, self.obj_ids[obj_is]):
            obj_info.append(
                {
                    "id": int(obj_id),
                    "bb": [int(min(x, x + w)), int(min(y, y + h)),
                           int(max(x, x + w)), int(max(y, y + h))],
                }
            )

        if self._augmenters is not None:
            out = self._augmenters(out)

        return out.astype(np.uint8), obj_info
