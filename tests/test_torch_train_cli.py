"""The port's `cli/ae_train` on the CPU (device="cpu") at a tiny width: it
renders the training set of a procedural mesh, trains, writes checkpoints
that serving restores, resumes where it stopped, writes its grids with the
stdlib PNG writer (pixel for pixel cv2.imwrite's), refuses a run
without CUDA unless given the CPU, and trains MODEL dsprites."""

import functools
import json
import os

import cv2
import numpy as np
import pytest
import torch

from augmentedautoencoder_torch import factory
from augmentedautoencoder_torch import workspace as ws
from augmentedautoencoder_torch.cli import ae_train
from augmentedautoencoder_torch.training import CheckpointManager
from augmentedautoencoder_torch.training.metrics import MetricWriter
from augmentedautoencoder_torch.utils.png import write_png

from _torch_port_ws import (  # noqa: F401 (global_rng_guard: autouse)
    TINY_CFG,
    dsprites_cfg,
    global_rng_guard,
    write_dsprites_npz,
    write_procedural_mesh,
)

torch.set_num_threads(1)


@pytest.fixture
def train_ws(tmp_path, monkeypatch):
    """A workspace with experiment `obj` (16 training images, 6 PNG
    backgrounds, NUM_ITER 4, SAVE_INTERVAL 2); sets AE_WORKSPACE_PATH. The
    runs write metrics.jsonl only: where tensorboard is installed, importing
    torch.utils.tensorboard also imports TensorFlow, which takes ~20 s."""
    monkeypatch.setattr(ae_train, "MetricWriter", functools.partial(MetricWriter, use_tensorboard=False))
    ply = write_procedural_mesh(tmp_path / "obj.ply")
    bg = tmp_path / "bg"
    bg.mkdir()
    rng = np.random.RandomState(0)
    for i in range(6):
        cv2.imwrite(str(bg / f"{i}.png"), rng.randint(0, 256, (40, 50, 3)).astype(np.uint8))
    text = (TINY_CFG.replace("/nonexistent/model.ply", ply).replace("/nonexistent/*.jpg", str(bg / "*.png"))
            .replace("NOOF_BG_IMGS: 0", "NOOF_BG_IMGS: 6").replace("NOOF_TRAINING_IMGS: 4", "NOOF_TRAINING_IMGS: 16")
            .replace("NUM_ITER: 10", "NUM_ITER: 4").replace("SAVE_INTERVAL: 10", "SAVE_INTERVAL: 2"))
    root = str(tmp_path / "ws")
    monkeypatch.setenv(ws.WORKSPACE_ENV_VAR, root)
    ws.init_workspace(root)
    cfg_file = ws.get_config_file_path(root, "obj")
    with open(cfg_file, "w") as fh:
        fh.write(text)
    return {"root": root, "cfg_file": cfg_file, "text": text}


def test_train_serve_and_resume(train_ws):
    trainer = ae_train.main(["obj"], device="cpu")
    assert trainer.step == 4 and int(trainer.optimizer.count) == 4
    paths = factory.experiment_paths("obj")
    assert os.path.exists(paths["exp_cfg_file"])  # the cfg copied into the log dir
    mgr = CheckpointManager(paths["checkpoint_dir"])
    assert mgr.all_steps() == [2, 4]
    _, _, model, payload = factory.restore_experiment("obj", device="cpu")
    assert payload["step"] == 4 and {"decoder", "opt_state"} <= set(payload)
    x = torch.rand(2, 32, 32, 3)
    trainer.model.eval()
    with torch.no_grad():
        assert torch.equal(model.encode(x), trainer.model.encode(x))
    cb = factory.build_codebook_from_name("obj", device="cpu")
    assert cb.test_embedding(np.zeros((1, 32, 32, 3), np.uint8)).shape == (16,)
    for step in (2, 4):
        grid = cv2.imread(os.path.join(paths["train_fig_dir"], f"training_images_{step}.png"))
        assert grid.shape == (4 * 32, 3 * 4 * 32, 3)

    # resume: a longer run continues at step 4
    with open(train_ws["cfg_file"], "w") as fh:
        fh.write(train_ws["text"].replace("NUM_ITER: 4", "NUM_ITER: 6"))
    resumed = ae_train.main(["obj"], device="cpu")
    assert resumed.step == 6 and int(resumed.optimizer.count) == 6
    assert mgr.all_steps() == [2, 4, 6]
    before = mgr.restore(4)["state_dict"]
    assert any(not torch.equal(v, resumed.model.state_dict()[k]) for k, v in before.items())


def test_gen_and_debug_grid(train_ws):
    assert ae_train.main(["obj", "-gen"], device="cpu") is None
    paths = factory.experiment_paths("obj")
    assert any(f.endswith(".npz") for f in os.listdir(paths["dataset_path"]))
    assert CheckpointManager(paths["checkpoint_dir"]).all_steps() == []
    assert ae_train.main(["obj", "-d"], device="cpu") is None
    grid = cv2.imread(os.path.join(paths["train_fig_dir"], "debug_augmented_batch.png"))
    assert grid.shape == (4 * 32, 2 * 2 * 32, 3)


def test_metrics_jsonl(train_ws):
    with open(train_ws["cfg_file"], "w") as fh:
        fh.write(train_ws["text"].replace("NUM_ITER: 4", "NUM_ITER: 20").replace("SAVE_INTERVAL: 2",
                                                                                "SAVE_INTERVAL: 20"))
    ae_train.main(["obj"], device="cpu")
    with open(os.path.join(factory.experiment_paths("obj")["checkpoint_dir"], "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["step"] for r in rows] == [10, 20]
    assert all(np.isfinite(r["total_loss"]) for r in rows)


def test_refuses_cpu_less_runs_and_dsprites(train_ws, tmp_path):
    """A run without CUDA and without device="cpu" is refused; MODEL
    dsprites, refused until the dsprites path was ported, now trains."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ae_train.main(["obj"])
    with open(ws.get_config_file_path(train_ws["root"], "sprites"), "w") as fh:
        fh.write(dsprites_cfg(write_dsprites_npz(tmp_path / "dsprites.npz")))
    trainer = ae_train.main(["sprites"], device="cpu")
    assert trainer.step == 4 and trainer.dataset.cfg.model == "dsprites"
    assert CheckpointManager(factory.experiment_paths("sprites")["checkpoint_dir"]).all_steps() == [2, 4]


@pytest.mark.parametrize("shape", [(17, 23, 3), (9, 30), (5, 6, 1), (128, 384, 3)])
def test_png_writer_matches_cv2(tmp_path, shape):
    img = np.random.RandomState(shape[0]).randint(0, 256, shape).astype(np.uint8)
    write_png(str(tmp_path / "port.png"), img)
    cv2.imwrite(str(tmp_path / "cv2.png"), img)
    got = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(tmp_path / "cv2.png"), cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
