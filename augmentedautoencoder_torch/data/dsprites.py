"""dSprites alternative training path (port of
augmentedautoencoder_tpu/data/dsprites.py; reference dataset.py:97-131).

The reference can train the AAE on the dSprites heart shape instead of
rendered views: MODEL_PATH points at the dsprites .npz, inputs are all heart
images (every latent combination), and targets are the same images with
position/scale/shape latents pinned so only ORIENTATION varies -- the AAE
learns an orientation-only code, mirroring the 3D pipeline in 2D.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# dsprites latent order: color, shape, scale, orientation, posX, posY
_HEART_COUNT = 245760  # first third of the dataset is the heart shape


def load_dsprites_training_images(dataset_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (train_x, train_y) uint8 (N, 64, 64, 1) in {0, 255}."""
    data = np.load(dataset_path, allow_pickle=True, encoding="latin1")
    imgs = data["imgs"]
    latents_classes = data["latents_classes"]
    metadata = data["metadata"][()]
    latents_sizes = metadata["latents_sizes"]
    latents_bases = np.concatenate((latents_sizes[::-1].cumprod()[::-1][1:], np.array([1])))

    heart = latents_classes[:_HEART_COUNT]
    heart_rot = heart.copy()
    # pin everything except orientation (reference dataset.py:113-119):
    # color=0, shape=0, scale=5, posX=16, posY=16
    heart_rot[:, 0] = 0
    heart_rot[:, 1] = 0
    heart_rot[:, 2] = 5
    heart_rot[:, 4] = 16
    heart_rot[:, 5] = 16

    def to_index(latents):
        return np.dot(latents, latents_bases).astype(int)

    train_y = imgs[to_index(heart_rot)]
    train_x = imgs[to_index(heart)]
    return (
        (train_x[..., None] * 255).astype(np.uint8),
        (train_y[..., None] * 255).astype(np.uint8),
    )


def codebook_images(train_y: np.ndarray) -> np.ndarray:
    """The orientation codebook's 40 images, f32 in [0, 1]: every 1024th
    pinned-latent target, rows 40-80 (reference codebook.py:164-185; the JAX
    package's ae_embed)."""
    return train_y[::1024][40:80].astype(np.float32) / 255.0
