"""Training in PRECISION bfloat16: the port against the JAX package on the
CPU, at 32x32x3, filters [8, 16], latent 8, batch 4, from the same Flax
parameters (`convert.params_from_jax`) and the same numpy inputs.

Both packages keep f32 parameters, run the convolutions and denses in bf16
(input, kernel and bias cast; the bias added to the rounded output), keep
BatchNorm's scale, bias and statistics in f32 and the latent,
reconstruction and mask heads in f32.

The bounds come from measuring each side against the same function in f64
(`models.reference.float64_model`: the port's modules in f64 throughout),
max |d| / max |f64| per tensor; `_held` prints the three gaps of every
tensor (pytest -rA):

  * Inference (`test_forward_matches_jax`): each side 3.9e-3 (z) and
    8.5e-4 to 2.2e-3 (reconstruction) from f64; port against JAX at most
    1.3e-6 (z, BatchNorm) and 1.7e-6 (the mask loss, an f32 mean).
  * Training, without BatchNorm: the bf16 layers' gradients 4.5e-3 to
    2.6e-1 from f64 on each side, port against JAX at most 0.42 of JAX's
    own gap (the VAE's decoder conv). With BatchNorm on a batch of 4, the
    f32 batch statistics sum in another order than XLA's, and where that
    moves a value across a bf16 rounding boundary the sides part by one
    bf16 ulp, which the batch amplifies: up to 0.85 of JAX's gap (the
    batch share of the decoder's dense BatchNorm variance, 9.3e-3 against
    1.09e-2 from f64).
  * Bias gradients: JAX's CPU backend sums the gradient of a bf16 bias in
    bf16 (`test_jax_cpu_sums_a_bf16_bias_gradient_in_bf16`): 1.4e-1 to
    1.9e-1 from f64 for the decoder's conv, where the port's sum, in f32
    rounded once, is 2.8e-3 to 7.1e-3. A bias gradient is therefore held
    to f64: at most BIAS_SHARE times JAX's own gap (measured: 1.5 at most).

So every other tensor is held to PAIR_SHARE (0.6) of JAX's own distance
from f64, BN_TRAIN_SHARE (1.0) with BatchNorm in training, or F32_RTOL
where that distance is smaller (f32 results). A port that computes a layer
in f32, fuses the bias before the bf16 rounding, normalizes in bf16, or
sums the fused 2x convolution's phase kernels in f32 fails these tests.

One op alone (`test_fused_upconv_bf16_matches_jax`) is held to OP_RTOL, two
bf16 ulps of the largest value: its output is rounded once to bf16, and
each side rounds some elements the other way (dx, dw 2.4e-3 to 6.4e-3
from f64 or apart); the forward is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.models import AAE as JaxAAE
from augmentedautoencoder_torch.convert import params_from_jax
from augmentedautoencoder_torch.models.reference import float64_loss, float64_model

from _torch_port_ws import global_rng_guard, jax_aae_variables, port_aae  # noqa: F401 (global_rng_guard: autouse)

torch.set_num_threads(1)

PAIR_SHARE = 0.6
BN_TRAIN_SHARE = 1.0
F32_RTOL = 1e-5
BIAS_SHARE = 2.0
OP_RTOL = 2.0 ** -7  # two bf16 ulps of the largest value: one op's rounding of its bf16 output

HW = 32
DIMS = dict(input_shape=(HW, HW, 3), latent_space_size=8, num_filters=(8, 16), strides=(2, 2))
VARIANTS = {
    "plain": {},
    "bn": {"batch_norm": True},
    "aux": {"auxiliary_mask": True},
    "vae": {"variational": 0.5},
    "bn_aux_vae": {"batch_norm": True, "auxiliary_mask": True, "variational": 0.25},
}


def _inputs(b=4, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, HW, HW, 3).astype(np.float32)
    y = (rng.rand(b, HW, HW, 3) * (rng.rand(b, HW, HW, 1) > 0.5)).astype(np.float32)
    return x, y


def _rel(got, want) -> float:
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_step(jm, variables, x, y, train, key):
    """JAX outputs (z, reconstruction, mask, losses), the gradients of the
    total loss in the port's layout, and the updated batch statistics."""
    def loss_fn(params):
        apply_vars = {**variables, "params": params}
        out, upd = jm.apply(apply_vars, jnp.asarray(x), jnp.asarray(y), train=train, rng=key,
                            mutable=["batch_stats"])
        aux = {"z": out.z, "reconstruction": out.reconstruction, "mask": out.pred_mask, "losses": out.losses}
        return out.total_loss, (aux, upd)

    (_, (aux, upd)), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    aux, grads, upd = jax.tree.map(np.array, (aux, grads, upd))
    grads = params_from_jax(grads, variables.get("batch_stats"), decoder=True)  # the statistics map BN's keys
    return aux, {k: v for k, v in grads.items() if not k.endswith(("running_mean", "running_var", "_tracked"))}, \
        upd.get("batch_stats")


def _port_step(model, x, y, train, noise):
    model.train(train)
    out = model(torch.from_numpy(x), torch.from_numpy(y), train=train, noise=noise)
    model.zero_grad()
    out.total_loss.backward()
    grads = {k: p.grad.detach() for k, p in model.named_parameters()}
    return out, grads


def _setup(variant, seed=0):
    kw = {**DIMS, **VARIANTS[variant]}
    jm = JaxAAE(precision="bfloat16", **kw)
    variables = jax_aae_variables(jm, DIMS["input_shape"], seed)
    return jm, variables, kw


def _held(variant, rows, share=PAIR_SHARE):
    """The rows (name, port, jax, f64, kind) that miss their bound; prints
    each row's three gaps (pytest -rA shows them)."""
    bad = []
    for name, port, want, ref in rows:
        port, want, ref = (t.detach().double().numpy() if isinstance(t, torch.Tensor) else t for t in (port, want, ref))
        pair, to_f64, jax_to_f64 = _rel(port, want), _rel(port, ref), _rel(want, ref)
        print(f"{variant} {name}: port-jax {pair:.2e} port-f64 {to_f64:.2e} jax-f64 {jax_to_f64:.2e}")
        if name.endswith(".bias"):
            ok = to_f64 <= BIAS_SHARE * jax_to_f64 + F32_RTOL
        else:
            ok = pair <= max(share * jax_to_f64, F32_RTOL)
        if not ok:
            bad.append((name, pair, to_f64, jax_to_f64))
    return bad


def _output_rows(got, want, ref):
    rows = [("z", got.z, want["z"], ref.z),
            ("reconstruction", got.reconstruction, want["reconstruction"], ref.reconstruction)]
    if want["mask"] is not None:
        rows.append(("mask", got.pred_mask, want["mask"], ref.pred_mask))
    assert set(got.losses) == set(want["losses"])
    return rows + [(k, got.losses[k], want["losses"][k], ref.losses[k]) for k in want["losses"]]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    """Inference mode (running statistics, the VAE decodes its mean): z,
    reconstruction, mask and every loss, f32 out of the f32 heads."""
    jm, variables, kw = _setup(variant)
    x, y = _inputs()
    out = jm.apply(variables, jnp.asarray(x), jnp.asarray(y), train=False)
    want = jax.tree.map(np.array, {"z": out.z, "reconstruction": out.reconstruction, "mask": out.pred_mask,
                                   "losses": out.losses})
    model = port_aae(variables, precision="bfloat16", **kw).eval()
    with torch.no_grad(), float64_loss():
        got = model(torch.from_numpy(x), torch.from_numpy(y))
        ref = float64_model(model)(torch.from_numpy(x).double(), torch.from_numpy(y).double())
    assert got.z.dtype == got.reconstruction.dtype == torch.float32
    bad = _held(variant, _output_rows(got, want, ref))
    assert not bad, bad


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gradients_match_jax(variant):
    """Training mode (batch statistics and their running update, the VAE
    decoding z + sigma * the noise JAX drew): the outputs and losses, each
    parameter's gradient, the running statistics; the parameters and their
    gradients stay f32."""
    jm, variables, kw = _setup(variant, seed=4)
    x, y = _inputs(seed=2)
    key = jax.random.PRNGKey(9)
    want, want_g, want_stats = _jax_step(jm, variables, x, y, True, key)
    noise = None
    if jm.variational > 0:
        noise = torch.from_numpy(np.array(jax.random.normal(key, want["z"].shape)))
    model = port_aae(variables, precision="bfloat16", **kw)
    got, got_g = _port_step(model, x, y, True, noise)
    with float64_loss():
        ref_model = float64_model(port_aae(variables, **kw))
        ref, ref_g = _port_step(ref_model, x, y, True, noise)
    assert set(got_g) == set(want_g)
    assert all(g.dtype == p.dtype == torch.float32 for g, p in zip(got_g.values(), model.parameters()))
    rows = _output_rows(got, want, ref)
    rows += [(k, g, want_g[k], ref_g[k]) for k, g in got_g.items()]
    if want_stats:
        # the batch's share of each running statistic, new - 0.99 old
        old = params_from_jax(variables["params"], variables["batch_stats"], decoder=True)
        new_stats = params_from_jax(variables["params"], want_stats, decoder=True)
        state, ref_state = model.state_dict(), ref_model.state_dict()
        for k, v in new_stats.items():
            if k.endswith(("running_mean", "running_var")):
                assert state[k].dtype == torch.float32, k
                rows.append((k, *(t.double() - 0.99 * old[k].double() for t in (state[k], v, ref_state[k]))))
    bad = _held(variant, rows, BN_TRAIN_SHARE if jm.batch_norm else PAIR_SHARE)
    assert not bad, bad


def test_jax_cpu_sums_a_bf16_bias_gradient_in_bf16():
    """The reason the bias gradients are held to f64: JAX's CPU backend
    reduces the gradient of a bf16 bias in bf16 (here 1,024 terms, several
    per cent off), the port's torch sum accumulates in f32 and rounds once."""
    g = jnp.asarray(np.random.RandomState(0).randn(4, 16, 16, 8), jnp.bfloat16)

    def f(b):
        y = jnp.zeros(g.shape, jnp.bfloat16) + b.astype(jnp.bfloat16)
        return jnp.sum(y.astype(jnp.float32) * g.astype(jnp.float32))

    exact = np.asarray(g, np.float64).sum((0, 1, 2))
    jax_grad = np.asarray(jax.grad(f)(jnp.zeros(8, jnp.float32)), np.float64)
    b = torch.zeros(8, requires_grad=True)
    (torch.zeros(4, 8, 16, 16, dtype=torch.bfloat16) + b.to(torch.bfloat16).view(-1, 1, 1)).backward(
        torch.from_numpy(np.asarray(g.astype(jnp.float32))).to(torch.bfloat16).permute(0, 3, 1, 2))
    port_err, jax_err = _rel(b.grad, exact), _rel(jax_grad, exact)
    assert port_err <= 2 ** -8 < jax_err, (port_err, jax_err)


# ------------------------------------------------------------------ the fused 2x convolution in bf16

@pytest.mark.parametrize("K", [3, 5])
def test_fused_upconv_bf16_matches_jax(K):
    """`upsample2x_conv` on bf16 operands (the decoder casts x, w and b):
    the phase kernels are the JAX sums of bf16 taps bit for bit, in the
    JAX loop's order; the output and the gradients of x, w and b against
    the JAX module's, both against the plain form in f64; the plain form in
    bf16 (upsample, then conv) too."""
    from augmentedautoencoder_tpu.ops import fused_upconv as jax_fu
    from augmentedautoencoder_torch.ops import fused_upconv as fu

    rng = np.random.RandomState(K)
    cin, cout = 6, 5
    x = rng.rand(2, 7, 9, cin).astype(np.float32)
    w = (rng.randn(K, K, cin, cout) / (K * cin ** 0.5)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    g = rng.randn(2, 14, 18, cout).astype(np.float32)
    bf = jnp.bfloat16
    wb = jnp.asarray(w, bf)
    w_port = torch.from_numpy(np.asarray(wb.astype(jnp.float32))).to(torch.bfloat16).permute(3, 2, 0, 1)
    for p in (0, 1):
        for q in (0, 1):
            want_k, want_r, want_c = jax_fu.phase_kernel(wb, p, q)
            got_k, got_r, got_c = fu.phase_kernel(w_port, p, q)
            assert (got_r, got_c) == (want_r, want_c)
            assert got_k.dtype == torch.bfloat16
            np.testing.assert_array_equal(got_k.permute(2, 3, 1, 0).float().numpy(),
                                          np.asarray(want_k.astype(jnp.float32)))

    args = tuple(jnp.asarray(a, bf) for a in (x, w, b))
    y, vjp = jax.vjp(jax_fu.upsample2x_conv, *args)
    want = [np.asarray(t.astype(jnp.float32)) for t in (y, *vjp(jnp.asarray(g, bf)))]
    want[0], want[1] = want[0].transpose(0, 3, 1, 2), want[1].transpose(0, 3, 1, 2)
    want[2] = want[2].transpose(3, 2, 0, 1)

    def run(fn, dtype):
        ts = [torch.from_numpy(np.asarray(jnp.asarray(a, bf).astype(jnp.float32))).to(dtype).requires_grad_()
              for a in (x, w, b)]
        xs, ws, bs = ts[0].permute(0, 3, 1, 2), ts[1].permute(3, 2, 0, 1), ts[2]
        out = fn(xs, ws, bs)
        out.backward(torch.from_numpy(np.asarray(jnp.asarray(g, bf).astype(jnp.float32))).to(dtype).permute(0, 3, 1, 2))
        return [out.detach(), ts[0].grad.permute(0, 3, 1, 2), ts[1].grad.permute(3, 2, 0, 1), ts[2].grad]

    got = run(fu.upsample2x_conv, torch.bfloat16)
    plain = run(fu.upsample2x_conv_plain, torch.bfloat16)
    ref = run(fu.upsample2x_conv_plain, torch.float64)
    assert all(t.dtype == torch.bfloat16 for t in got)
    np.testing.assert_array_equal(got[0].float().numpy(), want[0])  # the forward, bit for bit
    gaps = {}
    for i, name in enumerate(("y", "dx", "dw", "db")):
        gaps[name] = (_rel(got[i].double(), want[i]), _rel(got[i].double(), ref[i]),
                      _rel(plain[i].double(), ref[i]), _rel(want[i], ref[i]))
        print(f"K{K} {name}: port-jax {gaps[name][0]:.2e} port-f64 {gaps[name][1]:.2e} "
              f"plain-f64 {gaps[name][2]:.2e} jax-f64 {gaps[name][3]:.2e}")
    for name, (pair, port_f64, plain_f64, _) in gaps.items():
        # JAX sums the bias gradient in bf16: db is held to f64 alone
        assert port_f64 <= OP_RTOL and plain_f64 <= OP_RTOL and (name == "db" or pair <= OP_RTOL), (name, gaps[name])


# ------------------------------------------------------------------ BatchNorm under a bf16 compute dtype

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_bf16_matches_flax(train):
    """A Flax `nn.BatchNorm(dtype=bfloat16)` against the port's on the same
    bf16 input: scale, bias and statistics stay f32, x is normalized in f32
    and the output cast to bf16 (equal to one bf16 ulp where the two f32
    sums round apart), and the running update of training within f32
    rounding."""
    import flax.linen as fnn

    from augmentedautoencoder_torch.models.encoder import FlaxBatchNorm2d

    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(4, 6, 5, 8) * 2 + 1, jnp.bfloat16)
    bn = fnn.BatchNorm(use_running_average=not train, dtype=jnp.bfloat16)
    variables = jax.tree.map(np.array, bn.init(jax.random.PRNGKey(0), x))
    variables["params"]["scale"] = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    variables["params"]["bias"] = rng.randn(8).astype(np.float32) * 0.1
    variables["batch_stats"]["mean"] = rng.randn(8).astype(np.float32) * 0.1
    variables["batch_stats"]["var"] = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    want, upd = bn.apply(variables, x, mutable=["batch_stats"])

    port = FlaxBatchNorm2d(8, eps=1e-5)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        port.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        port.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        port.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    port.train(train)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt)
    assert got.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in (port.weight, port.bias, port.running_mean, port.running_var))
    got, want = got.permute(0, 2, 3, 1).float().numpy(), np.asarray(want.astype(jnp.float32))
    ulp = np.abs(want) * 2.0 ** -8 + 1e-30
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()
    assert np.mean(got == want) >= 0.99
    if train:
        for name, buf in (("mean", port.running_mean), ("var", port.running_var)):
            np.testing.assert_allclose(buf.numpy(), np.asarray(upd["batch_stats"][name]), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ one whole optax step

@pytest.mark.parametrize("optimizer", ["Adam", "Momentum"])
def test_one_train_step_matches_jax(optimizer):
    """A bf16 config's whole step (batch draw, forward, backward, optax
    update) from a JAX train state after two steps, on the batch the JAX
    step draws: the losses, and each parameter's update (after - before)
    against the JAX update, both against the port's step in f64 from the
    same state. The update is made on f32 parameters, which stay f32, as
    the optimizer's slots do."""
    from augmentedautoencoder_tpu.config import TrainConfig as JaxTrainConfig
    from augmentedautoencoder_tpu.data import augment_spec as JS
    from augmentedautoencoder_tpu.data.pipeline import DeviceDataset as JaxDeviceDataset
    from augmentedautoencoder_tpu.training import create_train_state, make_train_step as jax_make_train_step
    from augmentedautoencoder_torch.config import TrainConfig
    from augmentedautoencoder_torch.convert import opt_state_from_jax
    from augmentedautoencoder_torch.data import augment_spec as TS
    from augmentedautoencoder_torch.models import AAE
    from augmentedautoencoder_torch.training import make_optimizer

    def cfg_of(cls, spec):
        cfg = cls(h=HW, w=HW, c=3, latent_space_size=8)
        cfg.num_filter, cfg.strides, cfg.batch_size, cfg.noof_training_imgs = [8, 16], [2, 2], 4, 16
        cfg.learning_rate, cfg.optimizer, cfg.precision = 1e-3, optimizer, "bfloat16"
        cfg.code = spec.Sequential([spec.Sometimes(0.5, spec.Multiply(mul=(0.8, 1.2)))])
        return cfg

    rng = np.random.RandomState(0)
    arrays = (rng.randint(0, 255, (16, HW, HW, 3), dtype=np.uint8), rng.rand(16, HW, HW) > 0.6)
    arrays = (*arrays, arrays[0].copy(), rng.randint(0, 255, (4, HW, HW, 3), dtype=np.uint8))
    jcfg, tcfg = cfg_of(JaxTrainConfig, JS), cfg_of(TrainConfig, TS)
    key = jax.random.PRNGKey(0)
    jds = JaxDeviceDataset(jcfg, *arrays)
    jm = JaxAAE.from_config(jcfg)
    state = create_train_state(key, jcfg, jm)
    step = jax_make_train_step(jm, jds, jcfg.batch_size)
    for _ in range(2):
        state, _ = step(state, key)
    batch_key = jax.random.split(jax.random.fold_in(key, state.step))[0]  # the batch the JAX step draws
    x, y = (np.array(a) for a in jds.sample_batch(batch_key, jcfg.batch_size))
    params, opt_leaves = jax.tree.map(np.array, (state.params, jax.tree.leaves(state.opt_state)))
    new_state, losses = step(state, key)  # donates `state`
    before = params_from_jax(params, None, decoder=True)
    want = {k: v.numpy().astype(np.float64) - before[k].numpy()
            for k, v in params_from_jax(jax.tree.map(np.array, new_state.params), None, decoder=True).items()}

    def port_step(dtype):
        model = AAE.from_config(tcfg, train=True)
        model.load_state_dict(before)
        if dtype == torch.float64:
            model = float64_model(model)
        opt = make_optimizer(model, tcfg)
        opt.load_state_dict(opt_state_from_jax(opt_leaves, params, tcfg.optimizer))
        model.train()
        with float64_loss():
            out = model(torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype), train=True)
        opt.zero_grad()
        out.total_loss.backward()
        opt.step()
        return model, opt, out

    model, opt, out = port_step(torch.float32)
    ref, _, _ = port_step(torch.float64)
    if optimizer == "Adam":  # optax counts Adam's steps alone
        assert int(opt.count) == int(new_state.step) == 3
    for k in losses:
        np.testing.assert_allclose(out.losses[k].item(), float(losses[k]), rtol=F32_RTOL, err_msg=k)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32 for d in opt.slots.values() for t in d.values())
    got = dict(model.named_parameters())
    refs = dict(ref.named_parameters())
    rows = [(k, got[k].double() - before[k].double(), want[k], refs[k] - before[k].double()) for k in want]
    bad = _held(optimizer, rows)
    assert not bad, bad
