"""The host-side dataset (port of augmentedautoencoder_tpu/data/dataset.py):
the codebook's view sphere and its rendered, cropped views, and the
training set.

Mirrors auto_pose/ae/dataset.py:
  * SO(3)-uniform training pairs: per sample a random rotation rendered
    twice (random light -> x, fixed light -> y), an offset square crop of x
    and its background mask, a tight crop of y (dataset.py:219-306)
  * md5(cfg section) keyed .npz / .npy caches (dataset.py:82-95, 146-174),
    under the JAX package's keys, so either package reads the other's
  * embedding view batches for the codebook build (dataset.py:308-352)
  * extract_square_patch crop geometry (dataset.py:354-373)

The card's machine has no OpenCV, so the crop's resize and the 1-channel
conversion are numpy, bit for bit what cv2 5.0.0 computes:
`resize_nearest` is cv2.INTER_NEAREST, INTER_LINEAR is
`pose.estimator.resize_linear_u8`, `bgr_to_gray` is
cv2.cvtColor(COLOR_BGR2GRAY). Background images are read from the `.npy`
cache, or decoded with PIL where it imports.

The renderer is built once, under a lock, by the first caller of
`Dataset.renderer`, and each batch reads it before it fans out to its
render threads (the JAX package builds it lazily without a lock, so its
threads race to build several). The training renders draw every random
number before the threads start, from one np.random.RandomState, in the
order the JAX package's serial loop draws them from the global stream: so
the threaded renders from seed s equal the JAX package's serial renders
after np.random.seed(s).
"""

from __future__ import annotations

import glob
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import cached_property
from typing import Optional, Tuple

import numpy as np

from ..config import TrainConfig
from ..geometry import transform, view_sampler
from ..pose.estimator import resize_linear_u8
from ..utils import md5_of


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


def decode_bgr(path: str) -> np.ndarray:
    """`cv2.imread(path)` (IMREAD_COLOR: 3-channel BGR uint8, EXIF
    orientation applied) through PIL, which is imported here so that the
    module imports where PIL is missing."""
    from PIL import Image, ImageOps

    with Image.open(path) as im:
        rgb = np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
    return np.ascontiguousarray(rgb[:, :, ::-1])


class Dataset:
    """The training set, the embedding view sphere and its rendered views
    for one object.

    `render_workers` > 1 renders on that many threads (the native
    rasterizer releases the GIL).
    """

    def __init__(self, dataset_path: str, cfg: TrainConfig, renderer=None, render_workers: int = 0):
        self.render_workers = render_workers or min(8, os.cpu_count() or 1)
        self.cfg = cfg
        self.shape = cfg.shape
        self.dataset_path = dataset_path
        self._renderer = renderer
        self._renderer_lock = threading.Lock()
        self.noof_training_imgs = cfg.noof_training_imgs
        self.bg_img_paths = sorted(glob.glob(cfg.background_images_glob))
        self.noof_bg_imgs = min(cfg.noof_bg_imgs, len(self.bg_img_paths))
        # filled by get_training_images / load_bg_images
        self.train_x = self.mask_x = self.train_y = self.noof_obj_pixels = self.bg_imgs = None

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

    # ------------------------------------------------------------- caches
    def training_cache_file(self, dataset_path: str) -> str:
        return os.path.join(dataset_path, md5_of(self.cfg.dataset_cache_items()) + ".npz")

    def bg_cache_file(self, dataset_path: str) -> str:
        key = md5_of(str(self.shape), str(self.noof_bg_imgs), self.cfg.background_images_glob)
        return os.path.join(dataset_path, key + ".npy")

    def get_training_images(self, dataset_path: str, rng: np.random.RandomState, progress: bool = True) -> None:
        """Load the training set from its `.npz` cache, or render it
        (drawing from `rng`) and write the cache."""
        cache_file = self.training_cache_file(dataset_path)
        if os.path.exists(cache_file):
            with np.load(cache_file) as data:
                self.train_x = data["train_x"].astype(np.uint8)
                self.mask_x = data["mask_x"]
                self.train_y = data["train_y"].astype(np.uint8)
        else:
            self.render_training_images(rng, progress=progress)
            os.makedirs(dataset_path, exist_ok=True)
            tmp = cache_file[: -len(".npz")] + f".{os.getpid()}.tmp.npz"
            np.savez(tmp, train_x=self.train_x, mask_x=self.mask_x, train_y=self.train_y)
            os.replace(tmp, cache_file)
        # mask_x is True on BACKGROUND pixels (depth == 0), so the object's
        # pixel count is the count of zeros (reference dataset.py:94)
        self.noof_obj_pixels = np.count_nonzero(self.mask_x == 0, axis=(1, 2))

    def load_bg_images(self, dataset_path: str, rng: np.random.RandomState) -> None:
        """The backgrounds from their `.npy` cache; without one, decoded
        with PIL (bit for bit the JAX package's cv2.imread path: shuffled
        by `rng`, images no larger than the crop resized bilinearly, a
        random crop, gray for C 1) and cached."""
        cache_file = self.bg_cache_file(dataset_path)
        if os.path.exists(cache_file):
            self.bg_imgs = np.load(cache_file)
            return
        try:
            import PIL  # noqa: F401
        except ImportError:
            raise FileNotFoundError(
                f"no background cache {cache_file} and no PIL to decode {self.cfg.background_images_glob}: "
                "provide the cache (written by either package from the same cfg) or install Pillow"
            ) from None
        h, w, c = self.shape
        bg_imgs = np.empty((self.noof_bg_imgs,) + self.shape, dtype=np.uint8)
        file_list = list(self.bg_img_paths[: self.noof_bg_imgs])
        rng.shuffle(file_list)
        for j, fname in enumerate(file_list):
            bgr = decode_bgr(fname)
            H, W = bgr.shape[:2]
            if H <= h or W <= w:
                bgr = resize_linear_u8(bgr, (max(W, w + 1), max(H, h + 1)))
                H, W = bgr.shape[:2]
            y0 = int(rng.rand() * (H - h))
            x0 = int(rng.rand() * (W - w))
            bgr = bgr[y0 : y0 + h, x0 : x0 + w, :]
            bg_imgs[j] = bgr_to_gray(bgr)[:, :, None] if c == 1 else bgr
        os.makedirs(dataset_path, exist_ok=True)
        np.save(cache_file, bg_imgs)
        self.bg_imgs = bg_imgs

    # ------------------------------------------------------------- rendering
    def draw_training_randoms(self, rng: np.random.RandomState):
        """(rotations, lights, offsets) of the whole training set, in the
        JAX serial loop's order of draws: every rotation first, then per
        image the random light of its x render and its two relative bbox
        offsets."""
        cfg, n = self.cfg, self.noof_training_imgs
        rots = [transform.random_rotation_matrix(rng.rand(3))[:3, :3] for _ in range(n)]
        lights, offsets = [], np.empty((n, 2))
        for i in range(n):
            lights.append(self.renderer.sample_light(True, rng=rng))
            offsets[i, 0] = rng.uniform(-cfg.max_rel_offset, cfg.max_rel_offset)
            offsets[i, 1] = rng.uniform(-cfg.max_rel_offset, cfg.max_rel_offset)
        return rots, lights, offsets

    def _render_pair(self, R: np.ndarray, light):
        """One training pair: (bgr_x, depth_x, bb_x) under `light`, and
        (bgr_y, bb_y) under the fixed light."""
        cfg = self.cfg
        W_r, H_r = cfg.render_dims
        t = np.array([0.0, 0.0, cfg.radius])
        bgr_x, depth_x, bb_x = self.renderer.render_with_bbox(
            0, W_r, H_r, cfg.K.copy(), R, t, cfg.clip_near, cfg.clip_far, light=light
        )
        bgr_y, _, bb_y = self.renderer.render_with_bbox(
            0, W_r, H_r, cfg.K.copy(), R, t, cfg.clip_near, cfg.clip_far, random_light=False
        )
        return bgr_x, depth_x, bb_x, bgr_y, bb_y

    def render_training_images(self, rng: np.random.RandomState, progress: bool = True) -> None:
        """Render the NOOF_TRAINING_IMGS pairs into train_x (offset crop of
        the random-light render), mask_x (its background) and train_y
        (tight crop of the fixed-light render), on `render_workers` threads."""
        cfg = self.cfg
        n, (H, W) = self.noof_training_imgs, (cfg.h, cfg.w)
        self.renderer  # built here, before any render thread starts
        rots, lights, offsets = self.draw_training_randoms(rng)
        self.train_x = np.empty((n,) + self.shape, dtype=np.uint8)
        self.mask_x = np.empty((n,) + self.shape[:2], dtype=bool)
        self.train_y = np.empty((n,) + self.shape, dtype=np.uint8)

        def process(i):
            if progress and i % 500 == 0:
                print(f"rendering training images {i}/{n}", flush=True)
            bgr_x, depth_x, obj_bb, bgr_y, obj_bb_y = self._render_pair(rots[i], lights[i])
            if obj_bb is None:
                raise RuntimeError("Object not visible in rendering. Have you scaled the vertices to mm (VERTEX_SCALE)?")
            _, _, w, h = obj_bb
            obj_bb_off = obj_bb + np.array([offsets[i, 0] * w, offsets[i, 1] * h, 0, 0])
            crop_x = extract_square_patch(bgr_x, obj_bb_off, cfg.pad_factor, resize=(W, H))
            mask_x = extract_square_patch(depth_x, obj_bb_off, cfg.pad_factor, resize=(W, H)) == 0.0
            crop_y = extract_square_patch(bgr_y, obj_bb_y, cfg.pad_factor, resize=(W, H))
            if self.shape[2] == 1:
                crop_x, crop_y = bgr_to_gray(crop_x)[:, :, None], bgr_to_gray(crop_y)[:, :, None]
            self.train_x[i] = crop_x
            self.mask_x[i] = mask_x
            self.train_y[i] = crop_y

        if self.render_workers > 1:
            with ThreadPoolExecutor(self.render_workers) as pool:
                list(pool.map(process, range(n)))
        else:
            for i in range(n):
                process(i)

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
