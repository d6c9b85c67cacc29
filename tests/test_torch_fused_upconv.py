"""The port's fused 2x upsample + conv (augmentedautoencoder_torch/ops/fused_upconv.py)
against the JAX package's and against the port's unfused form: the forward
and the gradients of x, w and b within 1e-5 of each tensor's largest |value|,
the phase kernels bit for bit. The phase kernels' autograd Function against
the loop of gathers it replaced (`_phase_kernels_autograd`, differentiated
by autograd): the forward bit for bit, the gradient of w within 1e-6 of its
largest |value| in f32 and OP_RTOL in bf16, where it also lies no farther
than the loop's from the exact sum."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.ops import fused_upconv as jax_fu
from augmentedautoencoder_torch.ops import fused_upconv as fu

REL = 1e-5
GRAD_RTOL_F32 = 1e-6
OP_RTOL = 2.0 ** -7  # tests/test_torch_bf16_train.py: one op's rounding of its bf16 output


def _inputs(K, H, W, bias, cin=6, cout=5, batch=2, seed=0):
    rng = np.random.RandomState(seed + 10 * K + H + W)
    x = rng.randn(batch, H, W, cin).astype(np.float32)  # NHWC
    w = (rng.randn(K, K, cin, cout) / K).astype(np.float32)  # HWIO
    b = rng.randn(cout).astype(np.float32) if bias else None
    g = rng.randn(batch, 2 * H, 2 * W, cout).astype(np.float32)  # cotangent of the output
    return x, w, b, g


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= REL, f"{name}: max |d| / max |want| = {err:.3e}"


def _torch_grads(fn, x, w, b, g):
    """Output (NHWC) and gradients (x NHWC, w HWIO, b) of fn on NCHW / OIHW."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().requires_grad_()
    bt = None if b is None else torch.from_numpy(b).requires_grad_()
    out = fn(xt, wt, bt)
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    grads = [xt.grad.permute(0, 2, 3, 1), wt.grad.permute(2, 3, 1, 0)] + ([] if b is None else [bt.grad])
    return out.detach().permute(0, 2, 3, 1).numpy(), [t.numpy() for t in grads]


CASES = [(K, hw, bias) for K in (3, 5) for hw in ((4, 6), (5, 7)) for bias in (True, False)]
IDS = [f"K{K}-{'odd' if hw[0] % 2 else 'even'}HW-{'bias' if bias else 'nobias'}" for K, hw, bias in CASES]


@pytest.mark.parametrize("K,hw,bias", CASES, ids=IDS)
def test_upsample2x_conv_matches_jax(K, hw, bias):
    x, w, b, g = _inputs(K, *hw, bias)
    args = (jnp.asarray(x), jnp.asarray(w)) + (() if b is None else (jnp.asarray(b),))
    want, vjp = jax.vjp(lambda *a: jax_fu.upsample2x_conv(*a), *args)
    want_grads = vjp(jnp.asarray(g))
    got, got_grads = _torch_grads(fu.upsample2x_conv, x, w, b, g)
    _close(got, want, "forward")
    for name, gg, wg in zip(("dx", "dw", "db"), got_grads, want_grads):
        _close(gg, wg, name)


@pytest.mark.parametrize("K,hw,bias", CASES, ids=IDS)
def test_upsample2x_conv_matches_the_plain_form(K, hw, bias):
    x, w, b, g = _inputs(K, *hw, bias, seed=1)
    got, got_grads = _torch_grads(fu.upsample2x_conv, x, w, b, g)
    want, want_grads = _torch_grads(fu.upsample2x_conv_plain, x, w, b, g)
    _close(got, want, "forward")
    for name, gg, wg in zip(("dx", "dw", "db"), got_grads, want_grads):
        _close(gg, wg, name)


@pytest.mark.parametrize("K", [1, 3, 5, 7])
def test_phase_kernel_equals_jax_bit_for_bit(K):
    _, w, _, _ = _inputs(K, 4, 4, False, cin=7, cout=3)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    for p in (0, 1):
        assert fu.phase_offsets(p, K) == jax_fu._phase_offsets(p, K)
        for q in (0, 1):
            want, wrpad, wcpad = jax_fu.phase_kernel(jnp.asarray(w), p, q)
            got, rpad, cpad = fu.phase_kernel(wt, p, q)
            assert (tuple(rpad), tuple(cpad)) == (tuple(wrpad), tuple(wcpad))
            np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), np.asarray(want))


def test_phase_kernel_offsets_for_k5_share_one_window():
    """K = 5: both parities read source offsets -1..1, so the four phases
    are one 3x3 convolution with 4 * Cout channels."""
    assert fu.phase_offsets(0, 5) == [-1, -1, 0, 0, 1]
    assert fu.phase_offsets(1, 5) == [-1, 0, 0, 1, 1]
    w = torch.randn(2, 3, 5, 5)
    assert fu.phase_kernels(w).shape == (2, 3, 2, 2, 3, 3)


def test_decoder_routes_every_exact_2x_step_through_the_fused_form(monkeypatch):
    """Three exact 2x steps and both 2x heads take upsample2x_conv; the
    non-2x step (7 -> 15) resizes and convolves."""
    from augmentedautoencoder_torch.models import decoder as dec

    calls = []

    def counting(x, w, b=None):
        calls.append(tuple(x.shape[2:]))
        return fu.upsample2x_conv(x, w, b)

    monkeypatch.setattr(dec, "upsample2x_conv", counting)
    model = dec.Decoder(output_shape=(30, 30, 3), latent_space_size=4, num_filters=(8, 6, 4),
                        kernel_size=3, strides=(2, 2, 2), auxiliary_mask=True)
    assert model.layer_dims == [(3, 3), (7, 7), (15, 15)]
    recon, mask = model(torch.randn(2, 4))
    assert recon.shape == (2, 30, 30, 3) and mask.shape == (2, 30, 30, 1)
    assert calls == [(15, 15), (15, 15)]  # the two heads; 3 -> 7 and 7 -> 15 are not exact 2x
    calls.clear()
    model = dec.Decoder(output_shape=(32, 32, 3), latent_space_size=4, num_filters=(8, 6, 4),
                        kernel_size=5, strides=(2, 2, 2))
    assert model(torch.randn(2, 4)).shape == (2, 32, 32, 3)
    assert calls == [(4, 4), (8, 8), (16, 16)]


def _phase_kernels_autograd(w):
    """The phase kernels as a loop of S gathers and additions, each
    differentiated by autograd (a scatter-add of each gather's gradient)."""
    cout, cin, K, _ = w.shape
    slots = torch.from_numpy(fu._tap_slots(K))
    flat = torch.cat([w.reshape(cout, cin, K * K), w.new_zeros(cout, cin, 1)], dim=2)
    kern = w.new_zeros((cout, cin) + tuple(slots.shape[1:]))
    for s in range(slots.shape[0]):
        kern = kern + flat[:, :, slots[s]]
    return kern


PK_CASES = [(K, dtype, co_ci) for K in (3, 5) for dtype in (torch.float32, torch.bfloat16)
            for co_ci in ((1, 1), (5, 6), (16, 8))]
PK_IDS = [f"K{K}-{str(dtype)[6:]}-{co}x{ci}" for K, dtype, (co, ci) in PK_CASES]


def _pk_inputs(K, dtype, co_ci, seed=0):
    gen = torch.Generator().manual_seed(seed + 100 * K + co_ci[0] * co_ci[1])
    w = torch.randn(co_ci + (K, K), generator=gen).to(dtype)
    g = torch.randn(co_ci + tuple(fu._tap_slots(K).shape[1:]), generator=gen).to(dtype)
    return w, g


def _w_grad(fn, w, g):
    ws = w.clone().requires_grad_()
    fn(ws).backward(g)
    return ws.grad


@pytest.mark.parametrize("K,dtype,co_ci", PK_CASES, ids=PK_IDS)
def test_phase_kernels_forward_equals_the_loop_bit_for_bit(K, dtype, co_ci):
    w, _ = _pk_inputs(K, dtype, co_ci)
    got, want = fu.phase_kernels(w), _phase_kernels_autograd(w)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("K,dtype,co_ci", PK_CASES, ids=PK_IDS)
def test_phase_kernels_grad_matches_the_loop(K, dtype, co_ci):
    """The gradient of w against the loop's autograd gradient; in bf16
    (four phase entries summed in f32, rounded once, where the loop rounds
    after each addition) also element by element no farther than the loop's
    from the exact (f64) sum of the same bf16 entries."""
    w, g = _pk_inputs(K, dtype, co_ci, seed=1)
    got, want = _w_grad(fu.phase_kernels, w, g), _w_grad(_phase_kernels_autograd, w, g)
    assert got.dtype == want.dtype == dtype
    got, want = got.double(), want.double()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= (GRAD_RTOL_F32 if dtype == torch.float32 else OP_RTOL), err
    if dtype == torch.bfloat16:
        exact = _w_grad(_phase_kernels_autograd, w.double(), g.double())
        assert ((got - exact).abs() <= (want - exact).abs()).all()


@pytest.mark.parametrize("K", [1, 3, 5, 7])
def test_phase_kernels_gradcheck_f64(K):
    w = torch.randn(3, 2, K, K, dtype=torch.float64, generator=torch.Generator().manual_seed(K),
                    requires_grad=True)
    assert torch.autograd.gradcheck(fu.phase_kernels, (w,))


def test_phase_kernels_reuse_the_cached_tap_map():
    w = torch.randn(2, 3, 5, 5)
    fu.phase_kernels(w)
    before = fu._tap_map.cache_info()
    fu.phase_kernels(w)
    after = fu._tap_map.cache_info()
    assert after.hits == before.hits + 1 and after.misses == before.misses
