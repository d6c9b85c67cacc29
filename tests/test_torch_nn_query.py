"""Port ops/nn_query vs the JAX package's: the plain versions on the CPU
against `cosine_top1_pallas` in interpret mode and the XLA functions.

Indices must be equal; values agree within atol 1e-5 (f32 dot products
summed in another order).
"""

from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from augmentedautoencoder_tpu.ops import nn_query as jnq
from augmentedautoencoder_torch.ops import nn_query as tnq

torch.set_num_threads(1)

ATOL = 1e-5


def _data(n, d, b, seed, dup_rows=()):
    rng = np.random.RandomState(seed)
    cb = rng.randn(n, d).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=1, keepdims=True)
    for src, dst in dup_rows:  # exact duplicates (cyclo 35 == cyclo 0 in real codebooks)
        cb[dst] = cb[src]
    z = rng.randn(b, d).astype(np.float32)
    return z, cb


def _pallas_top1(z, cb, tile_n=256):
    orig = pl.pallas_call
    with jax.disable_jit():
        with mock.patch.object(pl, "pallas_call", partial(orig, interpret=True)):
            v, i = jnq.cosine_top1_pallas.__wrapped__(jnp.asarray(z), jnp.asarray(cb), tile_n=tile_n)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("n", [300, 700])  # neither a multiple of the 256-row tile
def test_top1_plain_matches_pallas_interpret(n):
    z, cb = _data(n, 128, 8, seed=n)
    want_v, want_i = _pallas_top1(z, cb)
    got_v, got_i = tnq.cosine_top1_cuda(torch.from_numpy(z), torch.from_numpy(cb))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=ATOL, rtol=0)
    assert tnq.cosine_top1_cuda.launches == 0  # CPU tensors never launch


def test_top1_duplicate_rows_tie_to_lowest_index():
    z, cb = _data(300, 128, 6, seed=3)
    zn = z / np.linalg.norm(z, axis=1, keepdims=True)
    best = np.argmax(zn @ cb.T, axis=1)
    # copy each query's best row to a LOWER and a HIGHER index: the lower wins
    for b, r in enumerate(best):
        lo, hi = 3 * b, 299 - 3 * b
        cb[lo] = cb[r]
        cb[hi] = cb[r]
    want_v, want_i = _pallas_top1(z, cb)
    got_v, got_i = tnq.cosine_top1(torch.from_numpy(z), torch.from_numpy(cb))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_i.numpy(), np.minimum(3 * np.arange(6), best))


def test_top1_bf16_codebook_matches_pallas():
    z, cb = _data(300, 128, 8, seed=4)
    cb_bf = jnp.asarray(cb, jnp.bfloat16)
    want_v, want_i = _pallas_top1(z, cb_bf)
    got_v, got_i = tnq.cosine_top1(torch.from_numpy(z), torch.from_numpy(cb).to(torch.bfloat16))
    assert got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", [100, 102])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_top1_padded_width_matches_pallas(bf16, d):
    """A codebook stored with zero columns up to the kernels' width (100
    stays 100 in f32, 102 -> 104; both -> 112 in bf16) and unpadded queries
    give `cosine_top1_pallas`'s result on the unpadded codebook."""
    from augmentedautoencoder_torch.ops import _cuda

    z, cb = _data(700, d, 8, seed=d, dup_rows=[(3, 300)])
    z[1] = cb[3]
    dtype = torch.bfloat16 if bf16 else torch.float32
    want_v, want_i = _pallas_top1(z, jnp.asarray(cb, jnp.bfloat16 if bf16 else jnp.float32))
    width = _cuda.stream_width(d, dtype)
    padded = tnq.pad_columns(torch.from_numpy(cb).to(dtype), width)
    assert padded.shape == (700, width) and not padded[:, d:].any()
    got_v, got_i = tnq.cosine_top1_cuda(torch.from_numpy(z), padded)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=ATOL, rtol=0)
    assert got_i[1] == 3


def test_pad_columns_refuses_a_narrower_codebook():
    with pytest.raises(ValueError, match="wider"):
        tnq.pad_columns(torch.zeros((2, 10)), 8)


@pytest.mark.parametrize("k", [1, 5, 20])
def test_cosine_similarity_topk_matches_xla(k):
    z, cb = _data(500, 32, 4, seed=k, dup_rows=[(10, 11), (40, 400)])
    want_v, want_i = jnq.cosine_similarity_topk(jnp.asarray(z), jnp.asarray(cb), k)
    got_v, got_i = tnq.cosine_similarity_topk(torch.from_numpy(z), torch.from_numpy(cb), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=ATOL, rtol=0)


def test_cosine_similarities_matches_xla():
    z, cb = _data(333, 16, 5, seed=8)
    want = np.asarray(jnq.cosine_similarities(jnp.asarray(z), jnp.asarray(cb)))
    got = tnq.cosine_similarities(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("k,stride,tta", [(1, 1, 1), (8, 1, 1), (1, 4, 1), (6, 4, 1), (4, 1, 3), (3, 4, 2)])
def test_cosine_topk_matches_xla(k, stride, tta):
    # duplicated rows inside the strided set exercise the tie order
    z, cb = _data(400, 16, 6 * tta, seed=10 + k + stride + tta, dup_rows=[(0, 8), (4, 396)])
    want_v, want_i = jnq.cosine_topk(jnp.asarray(z), jnp.asarray(cb), k=k, stride=stride, tta=tta)
    got_v, got_i = tnq.cosine_topk(torch.from_numpy(z), torch.from_numpy(cb), k=k, stride=stride, tta=tta)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=ATOL, rtol=0)


def test_l2_normalize_eps_on_squared_norm():
    z = np.array([[3.0, 4.0], [0.0, 0.0], [1e-7, 0.0]], np.float32)
    want = np.asarray(jnq.l2_normalize(jnp.asarray(z)))
    got = tnq.l2_normalize(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_kernel_wrapper_refuses_other_devices():
    z, cb = _data(10, 8, 2, seed=0)
    with pytest.raises(ValueError):
        tnq.cosine_top1_cuda(torch.from_numpy(z).to("meta"), torch.from_numpy(cb).to("meta"))
