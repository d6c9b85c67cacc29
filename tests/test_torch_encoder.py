"""Port Encoder vs the Flax Encoder on identical parameters (f32, atol 1e-4).

Covers the SAME padding (1 before / 2 after at k=5, s=2), BatchNorm after
the ReLU with running statistics, the NHWC flatten into the latent head,
the VAE mean, and the `params_from_jax` round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.models import AAE as JaxAAE
from augmentedautoencoder_torch.convert import params_from_jax
from augmentedautoencoder_torch.models import AAE, same_padding

torch.set_num_threads(1)

ATOL = 1e-4  # f32 convs in two libraries: summation order differs


def _jax_model(hw, batch_norm, variational):
    return JaxAAE(
        input_shape=(hw, hw, 3), latent_space_size=16, num_filters=(8, 16),
        strides=(2, 2), batch_norm=batch_norm, variational=variational,
    )


def _init(model, hw, seed):
    x = jnp.zeros((1, hw, hw, 3))
    variables = model.init({"params": jax.random.PRNGKey(seed)}, x, x)
    variables = jax.tree.map(np.asarray, dict(variables))
    rng = np.random.RandomState(seed)
    if "batch_stats" in variables:
        # non-trivial running statistics and affine terms
        stats = variables["batch_stats"]["encoder"]
        for name in stats:
            stats[name]["mean"] = rng.randn(*stats[name]["mean"].shape).astype(np.float32) * 0.1
            stats[name]["var"] = rng.uniform(0.5, 2.0, stats[name]["var"].shape).astype(np.float32)
            p = variables["params"]["encoder"][name]
            p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
            p["bias"] = rng.randn(*p["bias"].shape).astype(np.float32) * 0.1
    if "latent_sigma" in variables["params"]["encoder"]:
        sig = variables["params"]["encoder"]["latent_sigma"]
        sig["kernel"] = rng.randn(*sig["kernel"].shape).astype(np.float32) * 0.05
    return variables


def _port(variables, hw, batch_norm, variational):
    model = AAE(
        input_shape=(hw, hw, 3), latent_space_size=16, num_filters=(8, 16),
        strides=(2, 2), batch_norm=batch_norm, variational=variational,
    )
    model.load_state_dict(params_from_jax(variables["params"], variables.get("batch_stats")))
    return model.eval()


@pytest.mark.parametrize("hw", [32, 64])
@pytest.mark.parametrize(
    "batch_norm,variational", [(False, 0.0), (True, 0.0), (False, 0.5)],
    ids=["plain", "bn", "vae"],
)
def test_encoder_matches_flax(hw, batch_norm, variational):
    jm = _jax_model(hw, batch_norm, variational)
    variables = _init(jm, hw, seed=hw + 3 * batch_norm)
    x = np.random.RandomState(1).rand(4, hw, hw, 3).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), method=jm.encode))
    with torch.no_grad():
        got = _port(variables, hw, batch_norm, variational).encode(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 16)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_vae_sigma_head_matches_flax():
    jm = _jax_model(32, False, 0.5)
    variables = _init(jm, 32, seed=5)
    x = np.random.RandomState(2).rand(3, 32, 32, 3).astype(np.float32)
    z_ref, s_ref = jm.apply(variables, jnp.asarray(x), method=lambda m, x: m.encoder(x))
    with torch.no_grad():
        z, s = _port(variables, 32, False, 0.5).encoder(torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=ATOL, rtol=0)


def test_params_from_jax_round_trip():
    jm = _jax_model(32, True, 0.0)
    variables = _init(jm, 32, seed=7)
    state = params_from_jax(variables["params"], variables["batch_stats"])
    enc = variables["params"]["encoder"]
    np.testing.assert_array_equal(
        state["encoder.convs.1.weight"].permute(2, 3, 1, 0).numpy(), enc["Conv_1"]["kernel"]
    )
    np.testing.assert_array_equal(state["encoder.latent.weight"].T.numpy(), enc["latent"]["kernel"])
    np.testing.assert_array_equal(
        state["encoder.bns.0.running_var"].numpy(), variables["batch_stats"]["encoder"]["BatchNorm_0"]["var"]
    )
    model = _port(variables, 32, True, 0.0)
    assert set(model.state_dict()) == set(state)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy())


@pytest.mark.parametrize("size,k,s,want", [(128, 5, 2, (1, 2)), (64, 5, 2, (1, 2)), (7, 5, 2, (2, 2)), (8, 1, 1, (0, 0))])
def test_same_padding_matches_xla(size, k, s, want):
    assert same_padding(size, k, s) == want
