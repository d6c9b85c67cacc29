"""Data-parallel training of the port (training/trainer.py over a
`parallel` mesh, BatchNorm on the global batch, the draws sliced after the
global draw) against the JAX package's mesh step, on the CPU over gloo:

  * W in {2, 4} ranks against `make_train_step(mesh=make_mesh(devices[:W]))`
    from the same JAX train state after 2 steps, on the batch (and VAE
    noise) the JAX step draws, each rank taking its rows: the global loss
    within rtol 1e-5 and every parameter and BatchNorm statistic within
    1e-5 on every rank, the bounds of tests/test_torch_training.py (plain,
    BATCH_NORMALIZATION with global statistics, VARIATIONAL);
  * W ranks of the port's Trainer against one process of it from the same
    seed and generator (`parallel.dryrun`), and the whole dry run;
  * the loop through cli/ae_train over 2 ranks: the primary rank renders
    the training set, only it writes checkpoints, a resume continues, and
    the run ends where one process ends.
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
from augmentedautoencoder_tpu.parallel import make_mesh as jax_make_mesh
from augmentedautoencoder_tpu.training import create_train_state, make_train_step as jax_make_train_step
from augmentedautoencoder_torch import factory
from augmentedautoencoder_torch.config import TrainConfig
from augmentedautoencoder_torch.convert import opt_state_from_jax, params_from_jax
from augmentedautoencoder_torch.data import augment_spec as TS
from augmentedautoencoder_torch.parallel import dryrun
from augmentedautoencoder_torch.parallel.dryrun import run_ranks
from augmentedautoencoder_torch.training import CheckpointManager

import _torch_ddp_ranks as ranks
from _torch_port_ws import global_rng_guard  # noqa: F401 (autouse)
from test_torch_train_cli import train_ws  # noqa: F401 (fixture)

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
H = 32
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
VARIANTS = {"plain": {}, "bn": {"batch_normalization": True}, "vae": {"variational": 0.5}}


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


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("world", [2, 4])
def test_w_ranks_match_the_jax_mesh_step(world, variant):
    kw = VARIANTS[variant]
    jcfg, tcfg = _cfg(JaxTrainConfig, JS, **kw), _cfg(TrainConfig, TS, **kw)
    jds = JaxDeviceDataset(jcfg, *_arrays())
    jm = JaxAAE.from_config(jcfg)
    state = create_train_state(KEY, jcfg, jm)
    step = jax_make_train_step(jm, jds, jcfg.batch_size, mesh=jax_make_mesh(jax.devices()[:world]))
    for _ in range(2):
        state, _ = step(state, KEY)
    rng_batch, rng_model = jax.random.split(jax.random.fold_in(KEY, state.step))  # what the JAX step draws
    x, y = (np.array(a) for a in jds.sample_batch(rng_batch, jcfg.batch_size))
    noise = None
    if jm.variational > 0:
        noise = np.array(jax.random.normal(rng_model, (jcfg.batch_size, jcfg.latent_space_size)))
    params, stats, opt_leaves = jax.tree.map(np.array, (state.params, state.batch_stats,
                                                        jax.tree.leaves(state.opt_state)))
    state3, losses = step(state, KEY)  # donates `state`

    got = run_ranks(ranks.step_from_state, world, "cpu", tcfg, params_from_jax(params, stats, decoder=True),
                    opt_state_from_jax(opt_leaves, params, tcfg.optimizer), x, y, noise)
    assert all(g["count"] == int(state3.step) == 3 for g in got)
    assert set(got[0]["losses"]) == set(losses)
    for k in losses:
        np.testing.assert_allclose(got[0]["losses"][k], float(losses[k]), rtol=LOSS_RTOL, err_msg=k)
    want = params_from_jax(state3.params, state3.batch_stats, decoder=True)
    if variant == "bn":
        assert any(k.endswith("running_var") for k in want)
    for r, g in enumerate(got):
        assert set(g["state"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(g["state"][k].numpy(), v.numpy(), atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"rank {r}: {k}")
            assert torch.equal(g["state"][k], got[0]["state"][k]), f"rank {r} differs from rank 0: {k}"


@pytest.mark.parametrize("world", [2, 4])
def test_w_ranks_match_one_process_from_the_same_generator(world):
    """The Trainer's steps over W ranks (each composing its slice of the
    global draws, BatchNorm and the VAE noise global) against one process
    of the port on the global batch from the Trainer's state: the loss,
    every gradient, every statistic and the update given the same
    gradients; the ranks' states equal."""
    cfg = _cfg(TrainConfig, TS, batch_normalization=True, variational=0.5, square_occlusion=0.25)
    got = run_ranks(dryrun.train_rank, world, "cpu", cfg, 1, 2)
    for c in got[0]["checks"]:
        assert c["loss_rel"] <= LOSS_RTOL and c["stat_err"] <= PARAM_ATOL and c["update_err"] == 0.0, c
        assert c["grad_rel"] <= 1e-3, c  # E[x^2] - mean^2 over a sum of 2 ranks' sums, not one mean
    assert all(g["state_sums"] == got[0]["state_sums"] for g in got)


def test_dryrun_multigpu_on_the_cpu():
    out = dryrun.dryrun_multigpu(2, "cpu")
    assert out["backend"] == "gloo" and len(out["steps"]) == 3 and out["weak_scaling_per_rank"] == 2
    assert all(q["max_abs_err"] == 0.0 for q in out["queries"].values())


def test_train_cli_over_two_ranks_writes_once_and_resumes(train_ws, capfd):  # noqa: F811
    """ae_train over 2 ranks: the primary rank renders and caches the
    training set, trains 4 steps with chkpt-2 and chkpt-4 (the other rank
    cannot write, test_torch_parallel); a resume continues to 6; the end
    equals one process's 6 steps within the step bounds."""
    got = run_ranks(ranks.train_cli, 2, "cpu", ["obj"])
    assert [g["step"] for g in got] == [4, 4]
    paths = factory.experiment_paths("obj")
    mgr = CheckpointManager(paths["checkpoint_dir"])
    assert mgr.all_steps() == [2, 4]
    assert capfd.readouterr().out.count("rendering training images 0/16") == 1  # the primary rank's
    with open(train_ws["cfg_file"], "w") as fh:
        fh.write(train_ws["text"].replace("NUM_ITER: 4", "NUM_ITER: 6"))
    got = run_ranks(ranks.train_cli, 2, "cpu", ["obj"])
    assert [g["step"] for g in got] == [6, 6] and mgr.all_steps() == [2, 4, 6]
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k
    # one process from scratch to 6 steps
    for step in mgr.all_steps():
        os.remove(mgr.path_for_step(step))
    one = ranks.train_cli("cpu", ["obj"])
    assert one["step"] == 6
    for k, v in one["state"].items():
        np.testing.assert_allclose(got[0]["state"][k].numpy(), v.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=k)
