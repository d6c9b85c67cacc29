"""The port's training (training/state.py, checkpoint.py, trainer.py) against
the JAX package's:

  * one whole train step from a JAX train state after 2 steps, carried by
    `params_from_jax(..., decoder=True)` and `opt_state_from_jax`, on the
    batch the JAX step draws: loss within rtol 1e-5, every parameter and
    BatchNorm statistic after the step within 1e-5 (the convolutions'
    gradients sum in other orders; Adam divides them by their own root
    mean square, which spreads a relative 1e-6 of the gradient into ~lr *
    1e-3 of the step);
  * `scripts/convert_jax_checkpoint.py --train` carries the decoder keys
    and the optimizer leaves, and without it writes the encoder alone;
  * the loop: the save cadence, the gentle stop, the metrics flushed after a
    crash, reproducibility from the seed, and a resume from a checkpoint
    that continues bit for bit as the uninterrupted run;
  * the checkpoint: a training checkpoint is served by
    `restore_experiment`, keeps its decoder and optimizer through
    `add_codebook`, and an encoder-only one cannot be resumed from.
"""

import os

import jax
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.config import TrainConfig as JaxTrainConfig
from augmentedautoencoder_tpu.data import augment_spec as JS
from augmentedautoencoder_tpu.data.pipeline import DeviceDataset as JaxDeviceDataset
from augmentedautoencoder_tpu.models import AAE as JaxAAE
from augmentedautoencoder_tpu.training import create_train_state, make_train_step as jax_make_train_step
from augmentedautoencoder_torch.config import TrainConfig
from augmentedautoencoder_torch.convert import opt_state_from_jax, params_from_jax
from augmentedautoencoder_torch.data import augment_spec as TS
from augmentedautoencoder_torch.data.pipeline import DeviceDataset
from augmentedautoencoder_torch.models import AAE
from augmentedautoencoder_torch.training import CheckpointManager, Trainer, make_optimizer
from augmentedautoencoder_torch.training.trainer import INIT_TAG, derive_seed

from _torch_port_ws import global_rng_guard  # noqa: F401 (autouse)

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
H = 32
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


def _cfg(cls, spec, **kw):
    cfg = cls(h=H, w=H, c=3, latent_space_size=8)
    cfg.num_filter, cfg.strides = [4, 8], [2, 2]
    cfg.batch_size, cfg.learning_rate, cfg.noof_training_imgs = 8, 1e-3, 16
    cfg.code = spec.Sequential([spec.Sometimes(0.5, spec.Multiply(mul=(0.8, 1.2)))])
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _arrays(n=16):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 255, (n, H, H, 3), dtype=np.uint8)
    masks = rng.rand(n, H, H) > 0.6
    bg = rng.randint(0, 255, (4, H, H, 3), dtype=np.uint8)
    return x, masks, x.copy(), bg


def _port_dataset(**kw):
    return DeviceDataset(_cfg(TrainConfig, TS, **kw), *_arrays(), device="cpu")


@pytest.mark.parametrize("variant", [{}, {"batch_normalization": True, "auxiliary_mask": True}],
                         ids=["plain", "bn_aux"])
def test_one_train_step_matches_jax(variant):
    jcfg, tcfg = _cfg(JaxTrainConfig, JS, **variant), _cfg(TrainConfig, TS, **variant)
    jds = JaxDeviceDataset(jcfg, *_arrays())
    jm = JaxAAE.from_config(jcfg)
    state = create_train_state(KEY, jcfg, jm)
    step = jax_make_train_step(jm, jds, jcfg.batch_size)
    for _ in range(2):
        state, _ = step(state, KEY)
    rng = jax.random.fold_in(KEY, state.step)  # the batch the JAX step draws
    x, y = (np.array(a) for a in jds.sample_batch(jax.random.split(rng)[0], jcfg.batch_size))
    params, stats, opt_leaves = jax.tree.map(np.array, (state.params, state.batch_stats,
                                                        jax.tree.leaves(state.opt_state)))
    state3, losses = step(state, KEY)  # donates `state`

    model = AAE.from_config(tcfg, train=True)
    model.load_state_dict(params_from_jax(params, stats, decoder=True))
    opt = make_optimizer(model, tcfg)
    opt.load_state_dict(opt_state_from_jax(opt_leaves, params, tcfg.optimizer))
    model.train()
    out = model(torch.from_numpy(x), torch.from_numpy(y), train=True)
    opt.zero_grad()
    out.total_loss.backward()
    opt.step()
    assert int(opt.count) == int(state3.step) == 3
    for k in losses:
        np.testing.assert_allclose(out.losses[k].item(), float(losses[k]), rtol=LOSS_RTOL, err_msg=k)
    got = model.state_dict()
    want = params_from_jax(state3.params, state3.batch_stats, decoder=True)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_convert_train_checkpoint(tmp_path, monkeypatch):
    from augmentedautoencoder_tpu import workspace as jws
    from augmentedautoencoder_tpu.training.checkpoint import CheckpointManager as JaxCheckpoints

    from _torch_port_ws import TINY_CFG, load_converter

    monkeypatch.setenv(jws.WORKSPACE_ENV_VAR, str(tmp_path))
    jws.init_workspace(str(tmp_path))
    with open(jws.get_config_file_path(str(tmp_path), "obj"), "w") as fh:
        fh.write(TINY_CFG.replace("OPTIMIZER: Adam", "OPTIMIZER: RMSprop").replace("BATCH_NORMALIZATION: False",
                                                                                "BATCH_NORMALIZATION: True"))
    from augmentedautoencoder_tpu.config import load_train_config as jload

    jcfg = jload(jws.get_config_file_path(str(tmp_path), "obj"))
    jcfg.noof_training_imgs = 16
    jm = JaxAAE.from_config(jcfg)
    state = create_train_state(KEY, jcfg, jm)
    step = jax_make_train_step(jm, JaxDeviceDataset(jcfg, *_arrays()), jcfg.batch_size)
    state, _ = step(state, KEY)
    state = jax.device_get(state)
    ckdir = jws.get_checkpoint_dir(jws.get_log_dir(str(tmp_path), "obj"))
    JaxCheckpoints(ckdir).save_train_state(1, state)
    converter = load_converter()
    converter.main(["obj"])
    enc_only = CheckpointManager(ckdir).restore(1)
    assert "decoder" not in enc_only and "opt_state" not in enc_only
    converter.main(["obj", "--train"])
    payload = CheckpointManager(ckdir).restore(1)
    want = params_from_jax(state.params, state.batch_stats, decoder=True)
    got = {**payload["state_dict"], **payload["decoder"]}
    assert set(got) == set(want) and any(k.startswith("decoder.bn_dense") for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    opt = opt_state_from_jax(jax.tree.leaves(state.opt_state), state.params, "rmsprop")
    assert payload["opt_state"]["name"] == "rmsprop" and set(payload["opt_state"]["slots"]) == {"nu"}
    for k, v in opt["slots"]["nu"].items():
        assert torch.equal(payload["opt_state"]["slots"]["nu"][k], v), k
    # the port's model and optimizer take it
    tcfg = _cfg(TrainConfig, TS, optimizer="RMSprop", batch_normalization=True)
    tcfg.latent_space_size, tcfg.num_filter = jcfg.latent_space_size, list(jcfg.num_filter)
    model = AAE.from_config(tcfg, train=True)
    CheckpointManager(ckdir).restore_train_state(model, make_optimizer(model, tcfg))


class _Writer:
    def __init__(self):
        self.rows = []

    def write_scalars(self, step, scalars):
        self.rows.append((step, scalars))


def test_trainer_save_cadence_and_metrics():
    ds = _port_dataset(num_iter=6, save_interval=3)
    writer = _Writer()
    trainer = Trainer(ds.cfg, ds, seed=1, metric_writer=writer)
    saved = []
    assert trainer.train(save_hook=lambda s, tr: saved.append(s), log_every=2, progress=False) == 6
    assert saved == [3, 6] and trainer.step == 6 and int(trainer.optimizer.count) == 6
    assert [s for s, _ in writer.rows] == [2, 4, 6]
    assert all(np.isfinite(v) for _, row in writer.rows for v in row.values())
    assert {"reconst_loss", "total_loss", "z_mean", "z_std"} <= set(writer.rows[0][1])


def test_gentle_stop_saves_and_exits():
    ds = _port_dataset(num_iter=1000, save_interval=1000)
    trainer = Trainer(ds.cfg, ds)
    orig = trainer.step_fn

    def stopping(gen):
        trainer.request_stop()
        return orig(gen)

    trainer.step_fn = stopping
    saved = []
    trainer.train(save_hook=lambda s, tr: saved.append(s), progress=False)
    assert trainer.step == 1 and saved == [1]


def test_crash_flushes_pending_metrics():
    ds = _port_dataset(num_iter=1000, save_interval=1000)
    writer = _Writer()
    trainer = Trainer(ds.cfg, ds, metric_writer=writer)
    orig, calls = trainer.step_fn, []

    def crashing(gen):
        calls.append(1)
        if len(calls) == 5:
            raise RuntimeError("boom")
        return orig(gen)

    trainer.step_fn = crashing
    with pytest.raises(RuntimeError, match="boom"):
        trainer.train(log_every=2, progress=False)
    assert [s for s, _ in writer.rows] == [2, 4]


def test_seeds_reproduce_and_resume_continues_bit_for_bit(tmp_path):
    assert derive_seed(0, INIT_TAG) not in {derive_seed(0, s) for s in range(1000)}
    ds = _port_dataset(num_iter=4, save_interval=2)
    a = Trainer(ds.cfg, ds, seed=3)
    a.train(progress=False)
    again = Trainer(ds.cfg, ds, seed=3)
    again.train(num_iter=2, progress=False)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_train_state(2, again.model, again.optimizer)
    b = Trainer(ds.cfg, ds, seed=3)
    payload = mgr.restore_train_state(b.model, b.optimizer)
    b.step = payload["step"]
    assert b.step == 2
    for k, v in again.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    b.train(progress=False)
    assert b.step == 4
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    for s, d in a.optimizer.slots.items():
        for k, v in d.items():
            assert torch.equal(b.optimizer.slots[s][k], v), (s, k)
    assert not torch.equal(Trainer(ds.cfg, ds, seed=4).model.encoder.latent.weight, a.model.encoder.latent.weight)


def test_train_checkpoint_serves_and_keeps_its_codebook(tmp_path):
    ds = _port_dataset(num_iter=2, save_interval=2)
    trainer = Trainer(ds.cfg, ds)
    trainer.train(progress=False)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_train_state(2, trainer.model, trainer.optimizer)
    mgr.add_codebook(np.ones((5, 8)), np.zeros((5, 4)))
    mgr.save_train_state(4, trainer.model, trainer.optimizer)  # carries the codebook forward
    p4 = mgr.restore(4)
    assert p4["embedding_normalized"].shape == (5, 8) and p4["embed_obj_bbs"].dtype == torch.int32
    assert {"decoder", "opt_state"} <= set(mgr.restore(2))  # add_codebook kept them
    serving = AAE.from_config(ds.cfg)
    serving.load_state_dict(p4["state_dict"])  # strict: the encoder alone
    x = torch.rand(3, H, H, 3)
    trainer.model.eval()
    with torch.no_grad():
        assert torch.equal(serving.eval().encode(x), trainer.model.encode(x))
    enc_only = CheckpointManager(str(tmp_path / "enc"))
    enc_only.save(1, serving.state_dict())
    with pytest.raises(KeyError, match="serving checkpoint"):
        enc_only.restore_train_state(trainer.model, trainer.optimizer)


def test_stage_timer_and_trace(tmp_path):
    from augmentedautoencoder_torch.training.profiler import StageTimer, trace

    timer = StageTimer()
    for _ in range(3):
        with timer.stage("step"):
            pass
    assert timer.summary()["step"]["count"] == 3 and timer.mean("step") >= 0.0
    with trace(str(tmp_path / "trace")) as prof:
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert any(e.key == "aten::sum" for e in prof.key_averages())
