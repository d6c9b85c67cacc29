"""The port's augmentation chain (data/augment.py) against the JAX
package's (augmentedautoencoder_tpu/data/augment.py): each of the 12 ops and
the combinators (Sequential in order and in random order, Sometimes, OneOf,
Noop), given the parameters the JAX op draws from its key (re-drawn here
with the same key splits), within 1e-5 on the [0, 1] scale the batch
reaches the model (the affine and blur matmuls and convs sum in other
orders). The port's own draws have the JAX draws' shapes and dtypes and
follow their distribution (thousands of draws from each side: frequencies,
means, spreads, per-channel shares and ranges), and the shared math
(`bilinear_sample`, `interp_matrix`) is the same function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.data import augment as ja
from augmentedautoencoder_tpu.data import augment_spec as JS
from augmentedautoencoder_torch.data import augment as ta
from augmentedautoencoder_torch.data import augment_spec as TS

from _torch_port_ws import assert_same_draw_distribution, global_rng_guard, jax_draw  # noqa: F401 (global_rng_guard: autouse)

torch.set_num_threads(1)

TOL = 1e-5  # on [0, 1]
SHAPE = (4, 12, 12, 3)
RNG = jax.random.PRNGKey(7)

# one spec per op and option (name, spec source): JS and TS are the same
# module's two copies, so each spec is built in both
OPS = {
    "affine": "Affine(scale=(1.0, 1.2))",
    "coarse_dropout": "CoarseDropout(p=0.2, size_percent=0.25)",
    "coarse_dropout_pc": "CoarseDropout(p=0.3, size_percent=0.2, per_channel=0.5)",
    "dropout": "Dropout(p=0.2)",
    "dropout_pc": "Dropout(p=0.2, per_channel=0.5)",
    "dropout_pc1": "Dropout(p=0.2, per_channel=1.0)",
    "dropout_pc03": "Dropout(p=0.2, per_channel=0.3)",
    "blur_scalar": "GaussianBlur(0.8)",
    "blur_range": "GaussianBlur((0.0, 1.5))",
    "blur_off": "GaussianBlur(0.0)",
    "add_int": "Add((-25, 25), per_channel=0.3)",
    "add_float": "Add((-10.5, 20.0))",
    "noise": "AdditiveGaussianNoise(loc=2.0, scale=(0.0, 12.0))",
    "noise_pc": "AdditiveGaussianNoise(scale=(0.0, 12.0), per_channel=0.5)",
    "noise_pc1": "AdditiveGaussianNoise(scale=5.0, per_channel=1.0)",
    "multiply": "Multiply((0.6, 1.4), per_channel=0.5)",
    "multiply_pc1": "Multiply((0.6, 1.4), per_channel=1.0)",
    "invert": "Invert(0.5)",
    "invert_pc": "Invert(0.5, per_channel=True)",
    "contrast": "ContrastNormalization((0.5, 2.2), per_channel=0.3)",
    "fliplr": "Fliplr(0.5)",
    "flipud": "Flipud(0.5)",
    "grayscale": "Grayscale((0.0, 1.0))",
}
COMBINATORS = {
    "sequential": "Sequential([Add((-20, 20)), Multiply((0.8, 1.2)), Fliplr(0.5)])",
    "random_order": "Sequential([Add((-20, 20)), Multiply((0.8, 1.2)), Invert(0.5), Fliplr(0.5)], random_order=True)",
    "sometimes": "Sometimes(0.5, ContrastNormalization((0.5, 2.0)))",
    "one_of": "OneOf([Add((-30, 30)), Grayscale(1.0), Dropout(p=0.3)])",
    "noop": "Noop()",
    "template": """Sequential([
        Sometimes(0.5, Affine(scale=(1.0, 1.2))),
        Sometimes(0.5, CoarseDropout( p=0.2, size_percent=0.05) ),
        Sometimes(0.5, GaussianBlur(0.9)),
        Sometimes(0.5, Add((-25, 25), per_channel=0.3)),
        Sometimes(0.3, Invert(0.2, per_channel=True)),
        Sometimes(0.5, Multiply((0.6, 1.4), per_channel=0.5)),
        Sometimes(0.5, Multiply((0.6, 1.4))),
        Sometimes(0.5, ContrastNormalization((0.5, 2.2), per_channel=0.3))
        ], random_order=False)""",
}


def _spec(module, src):
    return eval(src, dict(module.DSL_CONSTRUCTORS))


def _imgs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, SHAPE).astype(np.float32)
    x[0, :3] = 0.0
    x[1, :3] = 255.0
    return x


def _t(a):
    return torch.from_numpy(np.array(a))


def _check(src, seed):
    jspec, tspec = _spec(JS, src), _spec(TS, src)
    x = _imgs(seed)
    rng = jax.random.fold_in(RNG, seed)
    want = np.asarray(ja.build_augmenter(jspec)(rng, jnp.asarray(x)))
    got = ta.build_augmenter(tspec).apply(jax_draw(jspec, rng, SHAPE), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == SHAPE
    np.testing.assert_allclose(got / 255.0, want / 255.0, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", list(OPS))
def test_op_matches_jax_given_its_draws(name):
    for seed in range(2):
        _check(OPS[name], seed)


@pytest.mark.parametrize("name", list(COMBINATORS))
def test_combinator_matches_jax_given_its_draws(name):
    for seed in range(3):
        _check(COMBINATORS[name], seed)


@pytest.mark.parametrize("name", list(OPS) + list(COMBINATORS))
def test_port_draws_have_the_jax_draws_layout(name):
    src = {**OPS, **COMBINATORS}[name]
    jspec, tspec = _spec(JS, src), _spec(TS, src)
    aug = ta.build_augmenter(tspec)
    gen = torch.Generator().manual_seed(3)
    got = aug.draw(gen, SHAPE, torch.device("cpu"))
    want = jax_draw(jspec, RNG, SHAPE)

    def layout(p):
        if isinstance(p, dict):
            return {k: (v if k == "perm" else layout(v)) for k, v in p.items() if k != "perm"}
        if isinstance(p, list):
            return [layout(v) for v in p]
        return (tuple(p.shape), p.dtype)

    if not (isinstance(tspec, TS.Sequential) and tspec.random_order):
        assert layout(got) == layout(want)
    out = aug.apply(got, torch.from_numpy(_imgs()))
    assert out.shape == SHAPE and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name", list(OPS) + list(COMBINATORS))
def test_port_draws_follow_the_jax_distribution(name):
    """2,000 images' draws from each side (a random order: 300 batches of
    8, for its permutations), the port's from one torch.Generator, the
    JAX package's from keys folded in one by one."""
    src = {**OPS, **COMBINATORS}[name]
    jspec, tspec = _spec(JS, src), _spec(TS, src)
    reps, b = (300, 8) if isinstance(tspec, TS.Sequential) and tspec.random_order else (1, 2000)
    shape = (b, 8, 8, 3)
    aug = ta.build_augmenter(tspec)
    gen = torch.Generator().manual_seed(5)
    port = [aug.draw(gen, shape, torch.device("cpu")) for _ in range(reps)]
    ref = [jax_draw(jspec, jax.random.fold_in(RNG, 1000 + r), shape) for r in range(reps)]
    assert_same_draw_distribution(port, ref)


def test_bilinear_sample_and_interp_matrix_are_the_jax_functions():
    rng = np.random.RandomState(4)
    img = rng.rand(9, 11, 3).astype(np.float32)
    ys = rng.uniform(-2, 11, (5, 7)).astype(np.float32)
    xs = rng.uniform(-2, 13, (5, 7)).astype(np.float32)
    ys[0, 0], xs[0, 0] = 8.0, 10.0  # the right edges exactly
    np.testing.assert_allclose(ta.bilinear_sample(torch.from_numpy(img), torch.from_numpy(ys), torch.from_numpy(xs)).numpy(),
                               np.asarray(ja._bilinear_sample(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))),
                               atol=1e-6, rtol=0)
    coords = rng.uniform(-1.5, 12.5, (3, 12)).astype(np.float32)
    coords[0, :3] = (0.0, 11.0, 5.0)
    np.testing.assert_array_equal(ta.interp_matrix(torch.from_numpy(coords), 12).numpy(),
                                  np.asarray(ja._interp_matrix(jnp.asarray(coords), 12)))


def test_unknown_op_is_refused():
    class Unknown(TS.AugSpec):
        pass

    with pytest.raises(NotImplementedError, match="Unknown"):
        ta.build_augmenter(Unknown())
