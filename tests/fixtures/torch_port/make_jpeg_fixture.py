"""Writes background_q95_420.jpg and background_q95_420_cv2.npy beside this file.

    python tests/fixtures/torch_port/make_jpeg_fixture.py

A seeded 96x128 BGR image (smooth colour fields plus noise, like a photo's
mix of flat and textured areas) written by cv2.imwrite at its defaults
(quality 95, baseline, 4:2:0 chroma subsampling, as VOC's JPEGs are), and
cv2.imread's decode of that file. The port's PIL decode
(augmentedautoencoder_torch/data/dataset.py `decode_bgr`) is held to the
stored decode byte for byte (tests/test_torch_jpeg.py, chip_smoke.py phase 10).
"""

import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG = os.path.join(HERE, "background_q95_420.jpg")
DECODED = os.path.join(HERE, "background_q95_420_cv2.npy")


def make_image(seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, (6, 8, 3)).astype(np.uint8)
    smooth = cv2.resize(coarse, (128, 96), interpolation=cv2.INTER_CUBIC).astype(np.int16)
    noise = rng.randint(-24, 25, (96, 128, 3)).astype(np.int16)
    return np.clip(smooth + noise, 0, 255).astype(np.uint8)


if __name__ == "__main__":
    if not cv2.imwrite(JPEG, make_image()):
        raise SystemExit(f"cv2.imwrite failed for {JPEG}")
    np.save(DECODED, cv2.imread(JPEG))
    print(f"wrote {JPEG} and {DECODED} (cv2 {cv2.__version__})")
