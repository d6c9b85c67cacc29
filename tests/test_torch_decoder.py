"""The port's Decoder and full AAE forward (models/decoder.py, models/aae.py)
against the Flax ones on identical parameters: reconstruction, mask head,
latent and every loss term, with BatchNorm (running statistics, and in
training the batch statistics and the running-average update), the
auxiliary mask and the VAE (the JAX-drawn noise injected), at 2x steps
and at the non-integer resizes of odd sizes. f32 throughout, atol 1e-4:
the convolutions of the two libraries sum in other orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.models import AAE as JaxAAE
from augmentedautoencoder_tpu.models.decoder import _nn_resize as jax_nn_resize
from augmentedautoencoder_torch.convert import params_from_jax
from augmentedautoencoder_torch.models import AAE
from augmentedautoencoder_torch.models.decoder import nn_resize

from _torch_port_ws import global_rng_guard, jax_aae_variables, port_aae  # noqa: F401 (global_rng_guard: autouse)

torch.set_num_threads(1)

ATOL = 1e-4

# (H, filters, strides): 2x steps only; 96 at three strides; 36 and 31,
# whose first step (4 -> 9, 7 -> 15) and, for 31, last (15 -> 31) are not 2x
SHAPES = {
    "h32": (32, (8, 16), (2, 2)),
    "h96": (96, (8, 16, 16), (2, 2, 2)),
    "h36": (36, (8, 16, 16), (2, 2, 2)),
    "h31": (31, (8, 16), (2, 2)),
}
VARIANTS = {
    "plain": {},
    "bn": {"batch_norm": True},
    "aux": {"auxiliary_mask": True},
    "vae": {"variational": 0.5},
    "reg_l1": {"norm_regularize": 0.3, "loss_type": "L1", "bootstrap_ratio": 1},
    "bn_aux_vae": {"batch_norm": True, "auxiliary_mask": True, "variational": 0.25},
    "k4": {"kernel_size_decoder": 4},  # an even kernel: SAME pads one more after than before
}


def _models(shape, variant, seed=0):
    hw, filters, strides = SHAPES[shape]
    kw = dict(input_shape=(hw, hw, 3), latent_space_size=8, num_filters=filters, strides=strides,
              **VARIANTS[variant])
    jm = JaxAAE(**kw)
    variables = jax_aae_variables(jm, (hw, hw, 3), seed)
    return jm, variables, port_aae(variables, **kw), hw


def _inputs(hw, b=3, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, hw, hw, 3).astype(np.float32)
    y = (rng.rand(b, hw, hw, 3) * (rng.rand(b, hw, hw, 1) > 0.5)).astype(np.float32)
    return x, y


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=0, err_msg=name)


CASES = [("h32", v) for v in VARIANTS] + [
    ("h96", "bn_aux_vae"), ("h36", "bn_aux_vae"), ("h31", "aux"),
]


@pytest.mark.parametrize("shape,variant", CASES)
def test_forward_matches_flax(shape, variant):
    """Inference mode: running statistics, the VAE decodes its mean."""
    jm, variables, model, hw = _models(shape, variant)
    x, y = _inputs(hw)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(y), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(y), train=False)
    assert got.reconstruction.shape == (3, hw, hw, 3)
    _close(got.z, want.z, "z")
    _close(got.reconstruction, want.reconstruction, "reconstruction")
    if jm.auxiliary_mask:
        _close(got.pred_mask, want.pred_mask, "mask")
    assert set(got.losses) == set(want.losses)
    for k in want.losses:
        _close(got.losses[k], want.losses[k], k)


@pytest.mark.parametrize("shape,variant", [("h32", "bn"), ("h36", "bn_aux_vae")])
def test_training_forward_matches_flax(shape, variant):
    """Training mode: BatchNorm on batch statistics with Flax's running
    update (0.99 old + 0.01 of the biased batch variance), the VAE decoding
    z + sigma * the noise JAX drew, and the z statistics."""
    jm, variables, model, hw = _models(shape, variant, seed=4)
    x, y = _inputs(hw, b=4, seed=2)
    key = jax.random.PRNGKey(9)
    apply_vars = {"params": variables["params"]}
    mutable = []
    if "batch_stats" in variables:
        apply_vars["batch_stats"] = variables["batch_stats"]
        mutable = ["batch_stats"]
    want, updates = jm.apply(apply_vars, jnp.asarray(x), jnp.asarray(y), train=True, rng=key, mutable=mutable)
    noise = None
    if jm.variational > 0:
        noise = torch.from_numpy(np.array(jax.random.normal(key, want.z.shape)))
    model.train()
    got = model(torch.from_numpy(x), torch.from_numpy(y), train=True, noise=noise)
    _close(got.reconstruction.detach(), want.reconstruction, "reconstruction")
    for k in want.losses:
        _close(got.losses[k].detach(), want.losses[k], k)
    if mutable:
        new_stats = params_from_jax(variables["params"], updates["batch_stats"], decoder=True)
        state = model.state_dict()
        for k, v in new_stats.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("src,dst", [((4, 4), (9, 9)), ((7, 5), (15, 11)), ((15, 15), (31, 31)),
                                     ((6, 6), (12, 12)), ((4, 3), (12, 9))])
def test_nn_resize_matches_jax(src, dst):
    x = np.random.RandomState(0).rand(2, *src, 3).astype(np.float32)
    want = np.asarray(jax_nn_resize(jnp.asarray(x), dst))
    got = nn_resize(torch.from_numpy(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_default_aae_stays_encoder_only():
    """Serving loads encoder-only state dicts into AAE(...): only
    decoder=True (from_config(train=True)) adds the decoder."""
    enc_only = AAE(input_shape=(32, 32, 3), latent_space_size=8, num_filters=(8, 16), strides=(2, 2))
    assert enc_only.decoder is None
    assert all(k.startswith("encoder.") for k in enc_only.state_dict())
    with pytest.raises(RuntimeError, match="decoder"):
        enc_only(torch.zeros(1, 32, 32, 3), torch.zeros(1, 32, 32, 3))
    full = AAE(input_shape=(32, 32, 3), latent_space_size=8, num_filters=(8, 16), strides=(2, 2), decoder=True)
    assert {k for k in full.state_dict() if k.startswith("encoder.")} == set(enc_only.state_dict())
    assert any(k.startswith("decoder.") for k in full.state_dict())
