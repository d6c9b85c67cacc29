"""Realistic occlusion mask bank loading (copy of
augmentedautoencoder_tpu/data/occlusion_masks.py, numpy only).

The reference reads `random_tless_masks/arbitrary_syn_masks_1000.bin` from
the workspace — a bit-packed array of 224x224 boolean silhouettes — via the
`bitarray` package (auto_pose/ae/dataset.py:405-418). Same file format here,
decoded with numpy (np.unpackbits is the bitarray.unpack equivalent), then
nearest-resized to the crop shape. A procedural fallback can synthesize a
mask bank when the file is absent so REALISTIC_OCCLUSION stays usable
without the asset.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

MASK_SOURCE_SIZE = 224


def load_mask_bank(path: str, target_shape: Tuple[int, int]) -> np.ndarray:
    """Decode the bit-packed mask file -> (N, H, W) bool."""
    raw = np.fromfile(path, dtype=np.uint8)
    bits = np.unpackbits(raw).astype(bool)
    n = len(bits) // (MASK_SOURCE_SIZE * MASK_SOURCE_SIZE)
    masks = bits[: n * MASK_SOURCE_SIZE * MASK_SOURCE_SIZE].reshape(
        n, MASK_SOURCE_SIZE, MASK_SOURCE_SIZE
    )
    h, w = target_shape
    ridx = (np.arange(h) * MASK_SOURCE_SIZE // h).astype(np.int64)
    cidx = (np.arange(w) * MASK_SOURCE_SIZE // w).astype(np.int64)
    return masks[:, ridx][:, :, cidx]


def workspace_mask_bank(
    workspace_path: str, target_shape: Tuple[int, int]
) -> Optional[np.ndarray]:
    """The reference's workspace location (dataset.py:411)."""
    path = os.path.join(
        workspace_path, "random_tless_masks", "arbitrary_syn_masks_1000.bin"
    )
    if os.path.exists(path):
        return load_mask_bank(path, target_shape)
    return None


def synthesize_mask_bank(
    n: int, target_shape: Tuple[int, int], seed: int = 0
) -> np.ndarray:
    """Procedural occluder silhouettes (random filled polygons/ellipses) for
    when the T-LESS mask asset is unavailable."""
    rng = np.random.RandomState(seed)
    h, w = target_shape
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.zeros((n, h, w), bool)
    for i in range(n):
        cy, cx = rng.uniform(0.25, 0.75, 2) * (h, w)
        ry, rx = rng.uniform(0.1, 0.3, 2) * (h, w)
        theta = rng.uniform(0, np.pi)
        y0, x0 = (yy - cy), (xx - cx)
        yr = y0 * np.cos(theta) - x0 * np.sin(theta)
        xr = y0 * np.sin(theta) + x0 * np.cos(theta)
        ellipse = (yr / ry) ** 2 + (xr / rx) ** 2 <= 1.0
        # rough edges: knock out random low-res blocks
        block = rng.rand(8, 8) > 0.25
        rough = block[(yy * 8 // h), (xx * 8 // w)]
        masks[i] = ellipse & rough
    return masks
