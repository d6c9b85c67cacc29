"""Generic helpers (copy of the part of augmentedautoencoder_tpu/utils/misc.py
the codebook embedding and training use).

  * batch_iteration_indices -- auto_pose/ae/utils.py:20-26
  * md5_of -- the dataset caches' key
  * tiles -- the training-health image grid
  * tiles4 -- the RGBD grid (reference meshrenderer/gl_utils/tiles.py:32-53)
  * lazy_property -- a property memoized on first access
"""

from __future__ import annotations

import functools
import hashlib
from typing import Iterator, Tuple

import numpy as np


def lazy_property(function):
    """Memoize a property on first access."""
    attribute = "_cache_" + function.__name__

    @property
    @functools.wraps(function)
    def wrapper(self):
        if not hasattr(self, attribute):
            setattr(self, attribute, function(self))
        return getattr(self, attribute)

    return wrapper


def batch_iteration_indices(n: int, batch_size: int) -> Iterator[Tuple[int, int]]:
    """Yield (start, end) index pairs covering [0, n) in batch_size chunks."""
    num = int(np.ceil(float(n) / float(batch_size)))
    for i in range(num):
        start = i * batch_size
        end = min(start + batch_size, n)
        yield (start, end)


def md5_of(*parts: object) -> str:
    """Stable md5 hex digest of the stringified parts (dataset cache keys)."""
    h = hashlib.md5()
    for p in parts:
        h.update(str(p).encode("utf-8"))
    return h.hexdigest()


def tiles(batch: np.ndarray, rows: int, cols: int, spacing_x: int = 0, spacing_y: int = 0,
          scale: float = 1.0) -> np.ndarray:
    """Arrange (N, H, W[, C]) images into a rows x cols float grid on a
    background of ones (nearest-neighbour resize when scale != 1)."""
    if batch.ndim == 3:
        batch = batch[..., None]
    elif batch.ndim != 4:
        raise ValueError(f"Invalid batch shape: {batch.shape}")
    n, h, w, c = batch.shape
    th, tw = int(h * scale), int(w * scale)
    grid = np.ones((rows * th + (rows - 1) * spacing_y, cols * tw + (cols - 1) * spacing_x, c), dtype=np.float64)
    for i in range(min(n, rows * cols)):
        row, col = divmod(i, cols)
        img = batch[i]
        if (th, tw) != (h, w):
            img = img[(np.arange(th) * h // th)][:, (np.arange(tw) * w // tw)]
        y0, x0 = row * (th + spacing_y), col * (tw + spacing_x)
        grid[y0:y0 + th, x0:x0 + tw] = img
    return grid


def tiles4(batch: np.ndarray, rows: int, cols: int, spacing_x: int = 0, spacing_y: int = 0,
           scale: float = 1.0) -> np.ndarray:
    """RGBD grid: each cell shows the color channels with the depth channel
    tiled directly below. batch: (N, H, W, 4), channels 0:3 color, 3 depth;
    returns a float grid of 2*rows x cols cells on a background of ones."""
    if batch.ndim != 4 or batch.shape[3] != 4:
        raise ValueError(f"tiles4 needs (N, H, W, 4), got {batch.shape}")
    rgb = batch[..., :3]
    depth = np.repeat(batch[..., 3:4], 3, axis=3)
    cells = np.ones((2 * rows * cols,) + rgb.shape[1:], dtype=np.float64)
    for i in range(min(batch.shape[0], rows * cols)):
        r, c = divmod(i, cols)
        cells[(2 * r) * cols + c] = rgb[i]
        cells[(2 * r + 1) * cols + c] = depth[i]
    return tiles(cells, 2 * rows, cols, spacing_x, spacing_y, scale)
