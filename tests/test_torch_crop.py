"""The port's OpenCV-free inference crop vs the JAX package's cv2 crop.

Target: bit-identical uint8 output, including OpenCV's 11-bit fixed-point
INTER_LINEAR weights, its vectorised rounding and its switch to
INTER_AREA for an exact 2x downscale.
"""

import cv2
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.pose.estimator import (
    extract_square_patch_centered as jax_crop,
)
from augmentedautoencoder_torch.pose.estimator import (
    extract_square_patch_centered,
    resize_linear_u8,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", range(6))
def test_resize_linear_bit_identical_to_cv2(seed):
    rng = np.random.RandomState(seed)
    for _ in range(40):
        sh = int(rng.randint(1, 300))
        sw = sh if rng.rand() < 0.7 else int(rng.randint(1, 300))
        dst = int(rng.choice([1, 2, 17, 32, 64, 100, 128]))
        img = rng.randint(0, 256, (sh, sw, 3)).astype(np.uint8)
        want = cv2.resize(img, (dst, dst), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(resize_linear_u8(img, (dst, dst)), want)


@pytest.mark.parametrize("src,dst", [(256, 128), (128, 64), (64, 128), (128, 128), (257, 128)])
def test_resize_exact_ratios_bit_identical_to_cv2(src, dst):
    img = np.random.RandomState(src).randint(0, 256, (src, src, 3)).astype(np.uint8)
    want = cv2.resize(img, (dst, dst), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(resize_linear_u8(img, (dst, dst)), want)


@pytest.mark.parametrize("black_borders", [True, False])
def test_crop_bit_identical_to_jax(black_borders):
    rng = np.random.RandomState(int(black_borders))
    scene = rng.randint(0, 256, (300, 400, 3)).astype(np.uint8)
    n = 0
    for _ in range(60):
        w, h = int(rng.randint(5, 260)), int(rng.randint(5, 260))
        if black_borders:  # the box lies inside the image
            w, h = min(w, 399), min(h, 299)
            x, y = int(rng.randint(0, 400 - w)), int(rng.randint(0, 300 - h))
        else:  # the padded square may reach past every edge
            x, y = int(rng.randint(-w // 2, 400)), int(rng.randint(-h // 2, 300))
            x, y = max(x, 0), max(y, 0)
        bb = [x + rng.rand(), y + rng.rand(), w + rng.rand(), h + rng.rand()]
        pad = float(rng.choice([1.0, 1.2, 1.5]))
        size = (128, 128) if rng.rand() < 0.8 else (64, 64)
        want = jax_crop(scene, bb, pad, resize=size, interpolation="linear", black_borders=black_borders)
        got = extract_square_patch_centered(scene, bb, pad, resize=size, interpolation="linear",
                                            black_borders=black_borders)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        n += 1
    assert n == 60


def test_crop_exact_2x_downscale_uses_area_rule():
    scene = np.random.RandomState(7).randint(0, 256, (400, 400, 3)).astype(np.uint8)
    bb = [50, 60, 256, 200]  # size = 256 * 1.0 -> exactly 2x onto 128
    want = jax_crop(scene, bb, 1.0, resize=(128, 128), black_borders=True)
    got = extract_square_patch_centered(scene, bb, 1.0, resize=(128, 128), black_borders=True)
    np.testing.assert_array_equal(got, want)
