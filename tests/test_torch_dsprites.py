"""The port's dsprites path (augmentedautoencoder_torch/data/dsprites.py,
cli/ae_train's dsprites branch) against the JAX package's on a synthetic
dsprites-format .npz: the real latent grid (737,280 images) with seeded 8x8
binary images, as tests/test_aux.py builds it."""

import functools

import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.data.dsprites import load_dsprites_training_images as jax_load
from augmentedautoencoder_torch import factory
from augmentedautoencoder_torch import workspace as ws
from augmentedautoencoder_torch.cli import ae_train
from augmentedautoencoder_torch.data.dsprites import codebook_images, load_dsprites_training_images
from augmentedautoencoder_torch.training import CheckpointManager
from augmentedautoencoder_torch.training.metrics import MetricWriter

from _torch_port_ws import dsprites_cfg, global_rng_guard, write_dsprites_npz  # noqa: F401 (global_rng_guard: autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_dsprites_npz(tmp_path_factory.mktemp("dsprites") / "dsprites.npz")


@pytest.fixture
def sprites_ws(npz, tmp_path, monkeypatch):
    """A workspace with the dsprites experiment `sprites` (NUM_ITER 4,
    SAVE_INTERVAL 2, batch 8); metrics.jsonl only (no tensorboard)."""
    monkeypatch.setattr(ae_train, "MetricWriter", functools.partial(MetricWriter, use_tensorboard=False))
    root = str(tmp_path / "ws")
    monkeypatch.setenv(ws.WORKSPACE_ENV_VAR, root)
    ws.init_workspace(root)
    with open(ws.get_config_file_path(root, "sprites"), "w") as fh:
        fh.write(dsprites_cfg(npz))
    return root


def test_loader_matches_jax(npz):
    tx, ty = load_dsprites_training_images(npz)
    jx, jy = jax_load(npz)
    assert tx.shape == ty.shape == (245760, 8, 8, 1) and tx.dtype == ty.dtype == np.uint8
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    # y pins every latent but orientation: 40 source images
    assert len(np.unique(ty.reshape(len(ty), -1), axis=0)) <= 40


def test_codebook_images_are_the_jax_embed_subset(npz):
    _, ty = load_dsprites_training_images(npz)
    imgs = codebook_images(ty)
    assert imgs.shape == (40, 8, 8, 1) and imgs.dtype == np.float32
    np.testing.assert_array_equal(imgs, jax_load(npz)[1][::1024][40:80].astype(np.float32) / 255.0)


def test_device_dataset_holds_the_jax_branch_arrays(sprites_ws, npz):
    """ae_train's dsprites branch: the heart images as x, the pinned ones as
    y, empty masks (every pixel an object pixel) and one black background,
    as augmentedautoencoder_tpu/cli/ae_train.py:63-69."""
    cfg, paths = factory.load_experiment_config("sprites", prefer_log_dir=False)
    ds = ae_train.load_device_dataset(cfg, paths, "cpu", seed=0)
    jx, jy = jax_load(npz)
    np.testing.assert_array_equal(ds.train_x.numpy(), jx)
    np.testing.assert_array_equal(ds.train_y.numpy(), jy)
    assert not ds.mask_x.any() and tuple(ds.mask_x.shape) == jx.shape[:3]
    assert (ds.noof_obj_pixels.cpu().numpy() == 64).all()
    assert tuple(ds.bg_imgs.shape) == (1, 8, 8, 1) and not ds.bg_imgs.any()
    assert ae_train.load_device_dataset(cfg, paths, "cpu", seed=0, gen_only=True) is None


def test_ae_train_trains_dsprites_on_the_cpu(sprites_ws):
    trainer = ae_train.main(["sprites"], device="cpu")
    assert trainer.step == 4 and int(trainer.optimizer.count) == 4
    paths = factory.experiment_paths("sprites")
    assert CheckpointManager(paths["checkpoint_dir"]).all_steps() == [2, 4]
    _, _, model, payload = factory.restore_experiment("sprites", device="cpu")
    assert payload["step"] == 4
    x = torch.from_numpy(codebook_images(load_dsprites_training_images(trainer.dataset.cfg.model_path)[1]))
    with torch.no_grad():
        assert torch.isfinite(model.encode(x)).all()
    assert ae_train.main(["sprites", "-gen"], device="cpu") is None  # dsprites renders nothing
