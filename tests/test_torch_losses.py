"""The port's losses (models/losses.py, ops/kth_value.py) against the JAX
package's on identical inputs.

  * the k-th largest value: bit-equal to the JAX bisection and to
    lax.top_k, ties and zeros included;
  * the bootstrapped loss: bit-equal where every sum is exact (errors on a
    1/16 grid, so any summation order gives the same f32), and within
    rtol 1e-6 on random errors (the two libraries sum in other orders);
    the selected set, and so the gradient's support, is identical;
  * the mask MSE, norm regularizer and KL within rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.models import losses as jl
from augmentedautoencoder_tpu.ops.kth_value import kth_largest as jax_kth_largest
from augmentedautoencoder_torch.models import losses as tl
from augmentedautoencoder_torch.ops.kth_value import kth_largest

from _torch_port_ws import global_rng_guard  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-6


def _pair(shape, seed, grid=None):
    rng = np.random.RandomState(seed)
    r, t = rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)
    if grid:
        r, t = np.round(r * grid) / grid, np.round(t * grid) / grid
    return r.astype(np.float32), t.astype(np.float32)


@pytest.mark.parametrize("k", [1, 7, 96, 300, 384])
def test_kth_largest_bit_equal(k):
    rng = np.random.RandomState(k)
    err = (rng.rand(5, 384).astype(np.float32) ** 3)
    err[1, :200] = 0.0  # tied zeros
    err[2, ::3] = err[2, 0]  # ties
    err[3, :10] = np.float32(1e-40)  # denormals
    got = kth_largest(torch.from_numpy(err), k).numpy()
    assert got.shape == (5, 1)
    np.testing.assert_array_equal(got, np.asarray(jax_kth_largest(jnp.asarray(err), k)))
    np.testing.assert_array_equal(got, np.asarray(jax.lax.top_k(jnp.asarray(err), k)[0][:, -1:]))


def test_kth_largest_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        kth_largest(torch.zeros(2, 4), 5)
    with pytest.raises(TypeError):
        kth_largest(torch.zeros(2, 4, dtype=torch.float64), 2)


@pytest.mark.parametrize("loss_type", ["L2", "L1"])
@pytest.mark.parametrize("ratio", [4, 1])
def test_bootstrapped_loss_bit_equal_on_exact_sums(loss_type, ratio):
    r, t = _pair((4, 16, 16, 3), seed=3, grid=16)
    want = jl.bootstrapped_reconstruction_loss(jnp.asarray(r), jnp.asarray(t), ratio, loss_type)
    got = tl.bootstrapped_reconstruction_loss(torch.from_numpy(r), torch.from_numpy(t), ratio, loss_type)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == np.asarray(want, np.float32).tobytes()


@pytest.mark.parametrize("loss_type", ["L2", "L1"])
@pytest.mark.parametrize("mode", ["exact", "sort"])
def test_bootstrapped_loss_and_gradient_match_jax(loss_type, mode):
    r, t = _pair((3, 12, 12, 3), seed=5)

    def jax_loss(rr):
        return jl.bootstrapped_reconstruction_loss(rr, jnp.asarray(t), 4, loss_type, topk_mode=mode)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(r))
    rt = torch.from_numpy(r).requires_grad_(True)
    got = tl.bootstrapped_reconstruction_loss(rt, torch.from_numpy(t), 4, loss_type, topk_mode=mode)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    g, wg = rt.grad.numpy(), np.asarray(want_grad)
    np.testing.assert_array_equal(g != 0, wg != 0)  # the same selected set
    np.testing.assert_allclose(g, wg, rtol=RTOL, atol=1e-12)


def test_approx_topk_is_refused():
    r, t = _pair((2, 8, 8, 3), seed=1)
    with pytest.raises(NotImplementedError, match="approx"):
        tl.bootstrapped_reconstruction_loss(torch.from_numpy(r), torch.from_numpy(t), 4, topk_mode="approx")


def test_mask_norm_and_kl_terms_match_jax():
    rng = np.random.RandomState(2)
    pred = rng.rand(3, 10, 10, 1).astype(np.float32)
    target = (rng.rand(3, 10, 10, 3) * (rng.rand(3, 10, 10, 1) > 0.4)).astype(np.float32)
    z = rng.randn(5, 16).astype(np.float32)
    sigma = rng.uniform(0.0, 2.0, (5, 16)).astype(np.float32)
    sigma[0, :3] = 0.0  # clamped at 1e-8
    pairs = [
        (tl.mask_loss(torch.from_numpy(pred), torch.from_numpy(target)), jl.mask_loss(pred, target)),
        (tl.norm_regularizer(torch.from_numpy(z)), jl.norm_regularizer(z)),
        (tl.kl_divergence_loss(torch.from_numpy(z), torch.from_numpy(sigma)), jl.kl_divergence_loss(z, sigma)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
