"""A tiny copy of a benchmark configuration for the CPU tests (widths and
pool cut far below any cell's; the cells themselves run on the card), and
a seeded random pool in place of the renders."""

import copy
import json
import os

import numpy as np

from .conftest import ROOT

TRAFFIC = {"kind": "train", "batch_size": 8, "log_every": 10, "check_steps": 3, "warmup_steps": 2,
           "trace_steps": 4}


def config(name="aae_template"):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    tiny = copy.deepcopy(cfg)
    tiny["cfg"]["Dataset"].update(H="32", W="32", NOOF_TRAINING_IMGS="64", NOOF_BG_IMGS="16")
    tiny["cfg"]["Network"].update(NUM_FILTER="[8, 16]", STRIDES="[2, 2]", LATENT_SPACE_SIZE="8")
    return tiny


def limits(cell):
    with open(os.path.join(ROOT, "portbench", "limits", cell + ".json")) as fh:
        return {k: v["limit"] for k, v in json.load(fh).items()}


def random_pool(config, cfg, data_dir):
    """(train_x, mask_x, train_y, noof_obj_pixels, bg) drawn from a fixed seed."""
    rng = np.random.RandomState(0)
    n, (h, w, c) = cfg.noof_training_imgs, cfg.shape
    train_x = rng.randint(0, 256, (n, h, w, c), dtype=np.uint8)
    mask_x = rng.rand(n, h, w) < 0.5
    train_y = rng.randint(0, 256, (n, h, w, c), dtype=np.uint8)
    bg = rng.randint(0, 256, (cfg.noof_bg_imgs, h, w, c), dtype=np.uint8)
    return train_x, mask_x, train_y, np.count_nonzero(~mask_x, axis=(1, 2)), bg


def patch_pool(monkeypatch):
    from portbench.kinds import train

    monkeypatch.setattr(train, "load_pool", random_pool)
    monkeypatch.setattr(train, "ensure_mesh", lambda config, data_dir: os.path.join(data_dir, "unused.ply"))
