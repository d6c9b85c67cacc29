"""The embedding half of the host-side dataset (port of
augmentedautoencoder_tpu/data/dataset.py:28-120, 255-317): the codebook's
view sphere and its rendered, cropped views.

Mirrors auto_pose/ae/dataset.py:
  * embedding view batches for the codebook build (dataset.py:308-352)
  * extract_square_patch crop geometry (dataset.py:354-373)

The card's machine has no OpenCV, so the crop's resize and the 1-channel
conversion are numpy, bit for bit what cv2 5.0.0 computes:
`resize_nearest` is cv2.INTER_NEAREST, INTER_LINEAR is
`pose.estimator.resize_linear_u8`, `bgr_to_gray` is
cv2.cvtColor(COLOR_BGR2GRAY).

The renderer is built once, under a lock, by the first caller of
`Dataset.renderer`, and each batch reads it before it fans out to its
render threads (the JAX package builds it lazily without a lock, so its
threads race to build several). The training renders and their buffers
come with the training slice of the port.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import cached_property
from typing import Tuple

import numpy as np

from ..config import TrainConfig
from ..geometry import view_sampler
from ..pose.estimator import resize_linear_u8


def resize_nearest(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST)` for an
    (H, W[, C]) image of any dtype: destination pixel x reads source
    min(floor(x * (1 / (dst_w / src_w))), src_w - 1), in float64, as
    OpenCV computes it (likewise for rows)."""
    dw, dh = dsize
    sh, sw = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / sw))).astype(np.int64), sw - 1)
    sy = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / sh))).astype(np.int64), sh - 1)
    return img[sy][:, sx]


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)` for (..., 3) uint8, bit for
    bit: OpenCV's 15-bit fixed-point weights with rounding (checked on all
    2^24 BGR triples against cv2 5.0.0)."""
    a = bgr.astype(np.int32)
    return ((3735 * a[..., 0] + 19235 * a[..., 1] + 9798 * a[..., 2] + 16384) >> 15).astype(np.uint8)


def extract_square_patch(
    scene_img: np.ndarray,
    bb_xywh,
    pad_factor: float,
    resize=(128, 128),
    interpolation: str = "nearest",
    black_borders: bool = False,
) -> np.ndarray:
    """Padded square crop around a bbox, resized (reference
    dataset.py:354-373): size = int(max(h, w) * pad_factor), the window
    centered at the bbox center and clamped to the image, then resized to
    `resize` (w, h) by nearest neighbour (any dtype) or, for uint8,
    bilinear interpolation."""
    if interpolation not in ("nearest", "linear"):
        raise ValueError(f"interpolation must be 'nearest' or 'linear', got {interpolation!r}")
    x, y, w, h = np.array(bb_xywh).astype(np.int32)
    size = int(np.maximum(h, w) * pad_factor)

    left = int(np.maximum(x + w / 2 - size / 2, 0))
    right = int(np.minimum(x + w / 2 + size / 2, scene_img.shape[1]))
    top = int(np.maximum(y + h / 2 - size / 2, 0))
    bottom = int(np.minimum(y + h / 2 + size / 2, scene_img.shape[0]))

    scene_crop = scene_img[top:bottom, left:right].copy()

    if black_borders:
        scene_crop[: (y - top), :] = 0
        scene_crop[(y + h - top):, :] = 0
        scene_crop[:, : (x - left)] = 0
        scene_crop[:, (x + w - left):] = 0

    if interpolation == "nearest":
        return resize_nearest(scene_crop, tuple(resize))
    if scene_crop.dtype != np.uint8:
        raise ValueError(f"linear interpolation takes uint8 images, got {scene_crop.dtype}")
    if scene_crop.ndim == 2:
        return resize_linear_u8(scene_crop[:, :, None], tuple(resize))[:, :, 0]
    return resize_linear_u8(scene_crop, tuple(resize))


class Dataset:
    """The embedding view sphere and its rendered views for one object.

    `render_workers` > 1 renders a batch's views on that many threads (the
    native rasterizer releases the GIL).
    """

    def __init__(self, dataset_path: str, cfg: TrainConfig, renderer=None, render_workers: int = 0):
        self.render_workers = render_workers or min(8, os.cpu_count() or 1)
        self.cfg = cfg
        self.shape = cfg.shape
        self.dataset_path = dataset_path
        self._renderer = renderer
        self._renderer_lock = threading.Lock()

    # ------------------------------------------------------------- renderer
    @property
    def renderer(self):
        """The object's native renderer, built on first use under a lock:
        the cfg's MODEL picks the shading as the reference picks meshrenderer
        vs meshrenderer_phong (dataset.py:60-80)."""
        with self._renderer_lock:
            if self._renderer is None:
                from ..renderer import Renderer

                self._renderer = Renderer(
                    [self.cfg.model_path],
                    samples=self.cfg.antialiasing,
                    vertex_tmp_store_folder=self.dataset_path,
                    vertex_scale=self.cfg.vertex_scale,
                    backend="native",
                    shading="cad" if self.cfg.model == "cad" else "vertex",
                    max_faces=self.cfg.max_render_faces or None,
                )
            return self._renderer

    # ------------------------------------------------------------- geometry
    @cached_property
    def viewsphere_for_embedding(self) -> np.ndarray:
        return view_sampler.viewsphere_rotations(self.cfg.min_n_views, self.cfg.num_cyclo, self.cfg.radius)

    @property
    def embedding_size(self) -> int:
        return len(self.viewsphere_for_embedding)

    # ------------------------------------------------------------- rendering
    def render_embedding_image_batch(self, start: int, end: int) -> Tuple[np.ndarray, np.ndarray]:
        """Render and crop embedding views [start, end): (batch uint8
        (n, H, W, C), obj_bbs (n, 4) float64), as reference
        dataset.py:308-352. uint8, because the encoder normalizes on the
        device and the host-to-device copy is 4x smaller than float32."""
        cfg = self.cfg
        renderer = self.renderer  # built here, before any render thread starts
        t = np.array([0.0, 0.0, cfg.radius])
        batch = np.empty((end - start,) + self.shape, dtype=np.uint8)
        obj_bbs = np.empty((end - start, 4))

        def render_one(R):
            bgr_y, _, obj_bb = renderer.render_with_bbox(
                0, cfg.render_dims[0], cfg.render_dims[1], cfg.K.copy(),
                R, t, cfg.clip_near, cfg.clip_far, random_light=False,
            )
            if obj_bb is None:
                raise RuntimeError(
                    "object not visible in an embedding view: check VERTEX_SCALE (mm) and RADIUS"
                )
            crop = extract_square_patch(bgr_y, obj_bb, cfg.pad_factor, resize=self.shape[:2])
            if self.shape[2] == 1:
                crop = bgr_to_gray(crop)[:, :, None]
            return crop, obj_bb

        views = self.viewsphere_for_embedding[start:end]
        if self.render_workers > 1:
            with ThreadPoolExecutor(self.render_workers) as pool:
                results = list(pool.map(render_one, views))
        else:
            results = [render_one(R) for R in views]
        for i, (crop, obj_bb) in enumerate(results):
            batch[i] = crop
            obj_bbs[i] = obj_bb
        return batch, obj_bbs

    def render_rot(self, R: np.ndarray, downSample: int = 1) -> np.ndarray:
        """One fixed-light view of rotation R, cropped, for visualization
        (reference dataset.py:177-216)."""
        cfg = self.cfg
        K = cfg.K.copy()
        K[:2, :] = K[:2, :] / downSample
        W_r = cfg.render_dims[0] // downSample
        H_r = cfg.render_dims[1] // downSample
        t = np.array([0.0, 0.0, cfg.radius])

        bgr_y, depth_y = self.renderer.render(
            0, W_r, H_r, K, R, t, cfg.clip_near, cfg.clip_far, random_light=False
        )
        ys, xs = np.nonzero(depth_y > 0)
        obj_bb = view_sampler.calc_2d_bbox(xs, ys, (W_r, H_r))
        return extract_square_patch(bgr_y, obj_bb, cfg.pad_factor, resize=self.shape[:2])
