"""The port's optimizers (training/state.py `OptaxOptimizer`) against optax
as the JAX package builds them (training/state.py `_OPTIMIZERS`), on a
Flax AAE parameter tree with BatchNorm: three updates from the same
parameters and gradients, parameters and optimizer state within 1e-6 of each tensor's largest
magnitude (f32 arithmetic in other orders and other sqrt / rsqrt / pow
implementations: a parameter that three updates of ~lr * 3 carry near 0
keeps their absolute rounding, not one relative to its own size). `convert.opt_state_from_jax` maps optax's flat leaves,
and a state carried over after two optax updates continues as optax does."""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from augmentedautoencoder_tpu.models import AAE as JaxAAE
from augmentedautoencoder_tpu.training.state import _OPTIMIZERS
from augmentedautoencoder_torch.convert import _flat_leaves, _port_name, opt_state_from_jax
from augmentedautoencoder_torch.training.state import OptaxOptimizer

from _torch_port_ws import global_rng_guard, jax_aae_variables  # noqa: F401 (global_rng_guard: autouse)

torch.set_num_threads(1)

RTOL = 1e-6
LR = 1e-2


@functools.lru_cache(maxsize=1)
def _flax_params():
    jm = JaxAAE(input_shape=(16, 16, 3), latent_space_size=4, num_filters=(4, 8), strides=(2, 2),
                batch_norm=True, auxiliary_mask=True)
    return jax_aae_variables(jm, (16, 16, 3), seed=0)["params"]


def _tree():
    return jax.tree.map(np.copy, _flax_params())


def _to_port(tree):
    """Flax-layout tree -> {port name: tensor}, with the parameters' layout."""
    out = {}
    for path, leaf in _flat_leaves(tree):
        key, fn = _port_name(*path)
        out[key] = fn(leaf)
    return out


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=RTOL * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _grads(params, step):
    rng = np.random.RandomState(100 + step)
    g = jax.tree.map(lambda p: (rng.randn(*p.shape) * 0.1).astype(np.float32), params)
    g["decoder"]["Conv_0"]["bias"][:] = 0.0  # a zero gradient (adagrad's where, adam's eps)
    return g


def _run_optax(name, params, steps):
    tx = _OPTIMIZERS[name](LR)
    state = tx.init(params)
    for s in range(steps):
        updates, state = tx.update(_grads(params, s), state, params)
        params = optax.apply_updates(params, updates)
    return params, state


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_three_updates_match_optax(name):
    params0 = _tree()
    want_params, want_state = _run_optax(name, params0, 3)
    named = {k: torch.nn.Parameter(v) for k, v in _to_port(params0).items()}
    opt = OptaxOptimizer(named.items(), name, LR)
    for s in range(3):
        for k, g in _to_port(_grads(params0, s)).items():
            named[k].grad = g
        opt.step()
    for k, v in _to_port(want_params).items():
        _close(named[k].detach().numpy(), v.numpy(), k)
    want = opt_state_from_jax(jax.tree.leaves(want_state), params0, name)
    got = opt.state_dict()
    assert got["name"] == want["name"] == name
    assert int(got["count"]) == int(want["count"])
    assert set(got["slots"]) == set(want["slots"])
    for slot in want["slots"]:
        for k, v in want["slots"][slot].items():
            _close(got["slots"][slot][k].numpy(), v.numpy(), f"{slot}/{k}")


@pytest.mark.parametrize("name", ["adam", "rmsprop", "adagrad", "momentum"])
def test_state_from_jax_continues_as_optax(name):
    """Two optax updates, their state carried over by opt_state_from_jax,
    then a third update on each side."""
    params0 = _tree()
    p2, s2 = _run_optax(name, params0, 2)
    want_params, _ = _run_optax(name, params0, 3)
    named = {k: torch.nn.Parameter(v) for k, v in _to_port(p2).items()}
    opt = OptaxOptimizer(named.items(), name, LR)
    opt.load_state_dict(opt_state_from_jax(jax.tree.leaves(s2), params0, name))
    for k, g in _to_port(_grads(params0, 2)).items():
        named[k].grad = g
    opt.step()
    for k, v in _to_port(want_params).items():
        _close(named[k].detach().numpy(), v.numpy(), k)


def test_defaults_are_optax_not_torch():
    """The formulas' constants, which torch.optim's defaults do not share."""
    assert OptaxOptimizer.rms_decay == 0.9 and OptaxOptimizer.rms_eps == 1e-8
    p = torch.nn.Parameter(torch.zeros(3))
    opt = OptaxOptimizer([("p", p)], "Adagrad", 0.1)
    assert torch.equal(opt.slots["sum_of_squares"]["p"], torch.full((3,), 0.1))
    with pytest.raises(ValueError):
        OptaxOptimizer([("p", p)], "lamb", 0.1)
    with pytest.raises(ValueError):
        opt_state_from_jax([], _tree(), "lamb")
