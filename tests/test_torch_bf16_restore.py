"""A PRECISION bfloat16 experiment through the port's entry points, against
the JAX package's on the CPU:

  * `ae_embed` encodes in the cfg's precision (bf16 convolutions, f32
    latent head), as the JAX `ae_embed` restores `AAE.from_config(cfg)`,
    on the render path and on the dsprites branch;
  * the decoder of `build_codebook_from_name(return_decoder=True)` decodes
    in the cfg's precision, as the JAX one does;
  * a BATCH_NORMALIZATION model served in bf16: BatchNorm's scale, bias and
    statistics stay f32 and it normalizes in f32, as Flax does (before,
    the port cast them to bf16 and added the conv bias before the bf16
    rounding: its codes were 5.1e-3 of their largest off the JAX codes,
    about as far as the f32 codes are; now 6.6e-7);
  * `ae_train` trains PRECISION bfloat16 (f32 parameters and optimizer
    state in every checkpoint), serves it in bf16 and in f32, and resumes.

Bounds: the inference gaps of tests/test_torch_bf16_train.py (port against
JAX at most 1.3e-6 of the largest code; the bf16 codes 3.9e-3 from f64),
held at CODE_RTOL 1e-4. Each repair's test also shows that the f32
computation it replaced is farther from the JAX codes than that.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from augmentedautoencoder_torch import factory
from augmentedautoencoder_torch import workspace as ws
from augmentedautoencoder_torch.cli import ae_embed, ae_train
from augmentedautoencoder_torch.convert import params_from_jax
from augmentedautoencoder_torch.training.checkpoint import CheckpointManager
from augmentedautoencoder_torch.training.metrics import MetricWriter

from _torch_port_ws import (  # noqa: F401 (global_rng_guard: autouse)
    TINY_CFG,
    dsprites_cfg,
    global_rng_guard,
    jax_aae_variables,
    make_frames,
    make_jax_workspace,
    write_dsprites_npz,
    write_procedural_mesh,
    write_test_cfg,
)

torch.set_num_threads(2)

CODE_RTOL = 1e-4
BF16 = "LEARNING_RATE: 1e-3\nPRECISION: bfloat16"
BN = ("BATCH_NORMALIZATION: False", "BATCH_NORMALIZATION: True")
EMBED_BATCH = 20


def _rel(got, want) -> float:
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _write_experiment(root, name, text, seed):
    """A bf16 experiment in both packages' checkpoints: the JAX AAE's full
    Flax variables (decoder included, non-trivial BatchNorm statistics)
    and a seeded codebook, in a JAX checkpoint and in the port's."""
    from augmentedautoencoder_tpu import workspace as jws
    from augmentedautoencoder_tpu.config import load_train_config
    from augmentedautoencoder_tpu.geometry import view_sampler
    from augmentedautoencoder_tpu.models import AAE as JaxAAE
    from augmentedautoencoder_tpu.training.checkpoint import CheckpointManager as JaxCheckpoints

    cfg_path = jws.get_config_file_path(str(root), name)
    with open(cfg_path, "w") as fh:
        fh.write(text)
    cfg = load_train_config(cfg_path)
    assert cfg.precision == "bfloat16"
    variables = jax_aae_variables(JaxAAE.from_config(cfg), cfg.shape, seed)
    n = len(view_sampler.viewsphere_rotations(cfg.min_n_views, cfg.num_cyclo, cfg.radius))
    rng = np.random.RandomState(seed)
    emb = rng.randn(n, cfg.latent_space_size).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    wh = rng.randint(20, 60, (n, 2))
    bbs = np.concatenate([np.array([64, 48]) - wh // 2, wh], axis=1).astype(np.int32)
    ckpt_dir = jws.get_checkpoint_dir(jws.get_log_dir(str(root), name))
    JaxCheckpoints(ckpt_dir).save(10, {"params": variables["params"], "batch_stats": variables["batch_stats"],
                                       "embedding_normalized": emb, "embed_obj_bbs": bbs})
    CheckpointManager(ckpt_dir).save(10, params_from_jax(variables["params"], variables["batch_stats"], decoder=True),
                                     emb, bbs)


@pytest.fixture(scope="module")
def bf16_ws(tmp_path_factory):
    """Experiments `bn16` (read by the serving tests) and `embed16`
    (re-saved by ae_embed): 32x32x3, filters [8, 16], latent 16, BatchNorm,
    PRECISION bfloat16, on a procedural mesh."""
    from augmentedautoencoder_tpu import workspace as jws

    root = tmp_path_factory.mktemp("bf16_ws")
    old = os.environ.get(ws.WORKSPACE_ENV_VAR)
    ply = write_procedural_mesh(root / "obj.ply")
    text = TINY_CFG.replace("LEARNING_RATE: 1e-3", BF16).replace(*BN).replace("/nonexistent/model.ply", ply)
    os.environ[ws.WORKSPACE_ENV_VAR] = str(root / "ws")
    jws.init_workspace(str(root / "ws"))
    for i, name in enumerate(("bn16", "embed16")):
        _write_experiment(root / "ws", name, text, seed=5 + i)
    yield root
    if old is None:
        os.environ.pop(ws.WORKSPACE_ENV_VAR, None)
    else:
        os.environ[ws.WORKSPACE_ENV_VAR] = old


@pytest.fixture
def in_ws(bf16_ws, monkeypatch):
    monkeypatch.setenv(ws.WORKSPACE_ENV_VAR, str(bf16_ws / "ws"))
    return bf16_ws


def _jax_encode(name, x):
    from augmentedautoencoder_tpu import factory as jax_factory

    _, _, model, payload = jax_factory.restore_experiment(name)
    return np.asarray(jax_factory.make_encode_fn(model, payload["params"], payload.get("batch_stats"))(x))


def test_batchnorm_bf16_serving_matches_jax(in_ws):
    """The codes of restore_experiment (the estimator's and the server's
    model) against the JAX encoder's, and the estimator's poses against
    the JAX estimator's."""
    from augmentedautoencoder_tpu.pose import AePoseEstimator as JaxEstimator
    from augmentedautoencoder_torch.pose import AePoseEstimator

    x = np.random.RandomState(0).rand(12, 32, 32, 3).astype(np.float32)
    want = _jax_encode("bn16", x)
    _, _, model, _ = factory.restore_experiment("bn16", device="cpu")
    f32 = factory.restore_experiment("bn16", device="cpu", precision="float32")[2]
    assert model.encoder.compute_dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in model.state_dict().values() if t.is_floating_point())
    with torch.no_grad():
        got, got_f32 = (m.encode(torch.from_numpy(x)).numpy() for m in (model, f32))
    assert _rel(got, want) <= CODE_RTOL < _rel(got_f32, want)

    cfg_path = write_test_cfg(in_ws / "bn16_test.cfg", {"cls": "bn16"})
    jest, est = JaxEstimator(cfg_path), AePoseEstimator(cfg_path, device="cpu")
    for fr in make_frames(["cls"], n_frames=2, dets_per_class=3, seed=7):
        got_p, want_p = est.process(**fr), jest.process(**fr)
        assert [p.name for p in got_p] == [p.name for p in want_p]
        for g, w in zip(got_p, want_p):
            np.testing.assert_allclose(g.trafo, w.trafo, atol=1e-5, rtol=0)


def test_decoder_decodes_in_the_cfg_precision(in_ws):
    """build_codebook_from_name(return_decoder=True): the reconstructions of
    the port's decoder against the JAX decoder's on the same codes."""
    from augmentedautoencoder_tpu import factory as jax_factory

    z = np.random.RandomState(1).randn(6, 16).astype(np.float32)
    _, decode = factory.build_codebook_from_name("bn16", return_decoder=True, device="cpu")
    _, jax_decode = jax_factory.build_codebook_from_name("bn16", return_decoder=True)
    want = np.asarray(jax_decode(z))
    got = decode(torch.from_numpy(z)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (6, 32, 32, 3)
    payload = factory.restore_experiment("bn16", device="cpu")[3]
    f32 = factory.AAE.from_config(factory.load_experiment_config("bn16")[0], precision="float32", train=True)
    f32.load_state_dict({**payload["state_dict"], **payload["decoder"]})
    got_f32 = factory.make_decode_fn(f32.eval())(z).numpy()
    assert _rel(got, want) <= CODE_RTOL < _rel(got_f32, want)


def test_ae_embed_renders_and_encodes_in_the_cfg_precision(in_ws):
    """The CLI's codebook against the JAX `Codebook.build_embedding` with the
    JAX package's bf16 model, on the same renders (the JAX Dataset given one
    Renderer built here)."""
    from augmentedautoencoder_tpu import factory as jax_factory
    from augmentedautoencoder_tpu.codebook import Codebook as JaxCodebook
    from augmentedautoencoder_tpu.renderer import Renderer as JaxRenderer

    cfg, paths, model, payload = jax_factory.restore_experiment("embed16")
    renderer = JaxRenderer([cfg.model_path], samples=cfg.antialiasing, vertex_tmp_store_folder=paths["dataset_path"],
                           vertex_scale=cfg.vertex_scale, backend="native")
    dataset = jax_factory.build_dataset(paths["dataset_path"], cfg, renderer=renderer)
    want, want_bbs = JaxCodebook.build_embedding(
        jax_factory.make_encode_fn(model, payload["params"], payload["batch_stats"]),
        dataset.render_embedding_image_batch, dataset.embedding_size, EMBED_BATCH, progress=False)
    path = ae_embed.main(["embed16", "--batch_size", str(EMBED_BATCH)], device="cpu")
    got = torch.load(path, map_location="cpu", weights_only=True)
    emb = got["embedding_normalized"].numpy()
    assert emb.shape == want.shape == (48, 16)
    np.testing.assert_array_equal(got["embed_obj_bbs"].numpy(), want_bbs.astype(np.int32))
    assert _rel(emb, want) <= CODE_RTOL
    # the f32 encode of the same renders, as ae_embed embedded before
    renders = dataset.render_embedding_image_batch(0, dataset.embedding_size)[0]
    f32 = factory.restore_experiment("embed16", device="cpu", precision="float32")[2]
    z32 = factory.make_encode_fn(f32)(torch.from_numpy(renders)).numpy()
    assert _rel(z32 / np.linalg.norm(z32, axis=1, keepdims=True), want) > CODE_RTOL


def test_ae_embed_dsprites_encodes_in_the_cfg_precision(tmp_path, monkeypatch):
    """The dsprites branch: the port's ae_embed against the JAX ae_embed on
    the same (converted) parameters under PRECISION bfloat16."""
    from augmentedautoencoder_tpu.cli import ae_embed as jax_ae_embed
    from augmentedautoencoder_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager

    npz = write_dsprites_npz(tmp_path / "dsprites.npz")
    root = tmp_path / "ws"
    monkeypatch.setenv(ws.WORKSPACE_ENV_VAR, str(root))
    make_jax_workspace(root, {"sprites": 5}, model_path=npz,
                       cfg_text=dsprites_cfg(npz).replace("LEARNING_RATE: 1e-3", BF16))
    paths = factory.experiment_paths("sprites")
    monkeypatch.setattr(sys, "argv", ["ae_embed", "sprites"])
    jax_ae_embed.main()
    want = np.asarray(JaxCheckpointManager(paths["checkpoint_dir"]).restore()["embedding_normalized"])
    emb = torch.load(ae_embed.main(["sprites"], device="cpu"), map_location="cpu", weights_only=True)
    emb = emb["embedding_normalized"].numpy()
    assert emb.shape == want.shape == (40, 8)
    assert _rel(emb, want) <= CODE_RTOL


@pytest.mark.parametrize("model", ["reconst", "dsprites"])
def test_ae_train_trains_bf16(model, tmp_path, monkeypatch):
    """ae_train on a PRECISION bfloat16 cfg (BatchNorm on): the parameters,
    statistics, decoder and optimizer slots stay f32 in the model and in
    every checkpoint; restore_experiment serves the checkpoint in bf16 as
    the trainer's model encodes, and in f32 as an f32 model of the same
    parameters; a longer run resumes from the last checkpoint."""
    import cv2

    monkeypatch.setattr(ae_train, "MetricWriter", functools.partial(MetricWriter, use_tensorboard=False))
    if model == "dsprites":
        text = dsprites_cfg(write_dsprites_npz(tmp_path / "dsprites.npz"))
        shape = (2, 8, 8, 1)
    else:
        ply = write_procedural_mesh(tmp_path / "obj.ply")
        bg = tmp_path / "bg"
        bg.mkdir()
        rng = np.random.RandomState(0)
        for i in range(6):
            cv2.imwrite(str(bg / f"{i}.png"), rng.randint(0, 256, (40, 50, 3)).astype(np.uint8))
        text = (TINY_CFG.replace("/nonexistent/model.ply", ply).replace("/nonexistent/*.jpg", str(bg / "*.png"))
                .replace("NOOF_BG_IMGS: 0", "NOOF_BG_IMGS: 6").replace("NOOF_TRAINING_IMGS: 4", "NOOF_TRAINING_IMGS: 16")
                .replace("NUM_ITER: 10", "NUM_ITER: 4").replace("SAVE_INTERVAL: 10", "SAVE_INTERVAL: 2"))
        shape = (2, 32, 32, 3)
    text = text.replace("LEARNING_RATE: 1e-3", BF16).replace(*BN)
    root = str(tmp_path / "ws")
    monkeypatch.setenv(ws.WORKSPACE_ENV_VAR, root)
    ws.init_workspace(root)
    cfg_file = ws.get_config_file_path(root, "exp")
    with open(cfg_file, "w") as fh:
        fh.write(text)

    trainer = ae_train.main(["exp"], device="cpu")
    assert trainer.step == 4 and trainer.model.encoder.compute_dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in trainer.model.state_dict().values() if t.is_floating_point())
    mgr = CheckpointManager(factory.experiment_paths("exp")["checkpoint_dir"])
    assert mgr.all_steps() == [2, 4]
    for step in (2, 4):
        payload = mgr.restore(step)
        tensors = [*payload["state_dict"].values(), *payload["decoder"].values(),
                   *(t for d in payload["opt_state"]["slots"].values() for t in d.values())]
        assert all(t.dtype == torch.float32 for t in tensors if t.is_floating_point())
    x = torch.rand(shape, generator=torch.Generator().manual_seed(0))
    trainer.model.eval()
    _, _, served, _ = factory.restore_experiment("exp", device="cpu")
    _, _, served32, _ = factory.restore_experiment("exp", device="cpu", precision="float32")
    f32 = factory.AAE.from_config(trainer.dataset.cfg, precision="float32")
    f32.load_state_dict(served32.state_dict())
    with torch.no_grad():
        assert torch.equal(served.encode(x), trainer.model.encode(x))
        assert torch.equal(served32.encode(x), f32.eval().encode(x))
        assert torch.isfinite(served.encode(x)).all()

    with open(cfg_file, "w") as fh:
        fh.write(text.replace("NUM_ITER: 4", "NUM_ITER: 6"))
    resumed = ae_train.main(["exp"], device="cpu")
    assert resumed.step == 6 and mgr.all_steps() == [2, 4, 6]
    assert all(p.dtype == torch.float32 for p in resumed.model.parameters())
