"""Port ops/multi_codebook vs the JAX package's Pallas kernels, run in
interpret mode on the CPU, across several 256-row tiles.

Indices must be equal; values agree within atol 1e-5.
"""

from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from augmentedautoencoder_tpu.ops import multi_codebook as jmc
from augmentedautoencoder_torch.ops import multi_codebook as tmc

torch.set_num_threads(1)

ATOL = 1e-5
TILE = 256


def _codebooks(sizes, d=32, seed=0, dups=()):
    rng = np.random.RandomState(seed)
    cbs = []
    for n in sizes:
        cb = rng.randn(n, d).astype(np.float32)
        cb /= np.linalg.norm(cb, axis=1, keepdims=True)
        cbs.append(cb)
    for obj, src, dst in dups:
        cbs[obj][dst] = cbs[obj][src]
    return cbs


def _interpret(fn, *args, **kw):
    orig = pl.pallas_call
    with jax.disable_jit():
        with mock.patch.object(pl, "pallas_call", partial(orig, interpret=True)):
            v, i = fn.__wrapped__(*args, **kw)
    return np.asarray(v), np.asarray(i)


def _slab(cbs, dtype=np.float32):
    slab, lengths = jmc.stack_codebooks(cbs, tile_n=TILE)
    return slab, lengths


@pytest.mark.parametrize("obj", [0, 1])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_grouped_top1_matches_pallas(obj, bf16):
    cbs = _codebooks([700, 300], seed=obj)  # 3 tiles; object 1 padded past n_valid
    slab, lengths = _slab(cbs)
    z = np.random.RandomState(5).randn(6, 32).astype(np.float32)
    jslab = jnp.asarray(slab, jnp.bfloat16 if bf16 else jnp.float32)
    want_v, want_i = _interpret(
        jmc.grouped_codebook_top1, jnp.asarray(z), jslab, jnp.asarray(obj, jnp.int32),
        jnp.asarray(lengths[obj], jnp.int32), tile_n=TILE,
    )
    tslab = torch.from_numpy(slab).to(torch.bfloat16 if bf16 else torch.float32)
    got_v, got_i = tmc.grouped_codebook_top1(torch.from_numpy(z), tslab, obj, int(lengths[obj]))
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=ATOL, rtol=0)
    assert (got_i.numpy() < lengths[obj]).all()


def test_grouped_top1_masks_pad_rows_for_negative_matches():
    # every true row scores negative: the zero pad rows (cos 0) must not win
    cbs = _codebooks([300, 700], seed=2)
    z = -cbs[0].sum(axis=0, keepdims=True).repeat(3, 0)
    cbs[0] = np.abs(cbs[0]) * np.sign(cbs[0].sum(axis=0))  # all rows align with -z
    cbs[0] /= np.linalg.norm(cbs[0], axis=1, keepdims=True)
    slab, lengths = _slab(cbs)
    want_v, want_i = _interpret(
        jmc.grouped_codebook_top1, jnp.asarray(z), jnp.asarray(slab), jnp.asarray(0, jnp.int32),
        jnp.asarray(lengths[0], jnp.int32), tile_n=TILE,
    )
    got_v, got_i = tmc.grouped_codebook_top1(torch.from_numpy(z), torch.from_numpy(slab), 0, int(lengths[0]))
    assert (want_v < 0).all()
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_grouped_topk_matches_pallas(k, stride, bf16):
    # exact duplicates straddling a tile edge, inside the strided set
    cbs = _codebooks([600, 900], seed=k + stride, dups=[(1, 4, 256), (1, 8, 512), (1, 12, 888)])
    slab, lengths = _slab(cbs)
    z = np.random.RandomState(k).randn(5, 32).astype(np.float32)
    z[0] = cbs[1][4]  # a query whose best match is tied three ways
    jslab = jnp.asarray(slab, jnp.bfloat16 if bf16 else jnp.float32)
    want_v, want_i = _interpret(
        jmc.grouped_codebook_topk, jnp.asarray(z), jslab, jnp.asarray(1, jnp.int32),
        jnp.asarray(lengths[1], jnp.int32), k=k, stride=stride, tile_n=TILE,
    )
    tslab = torch.from_numpy(slab).to(torch.bfloat16 if bf16 else torch.float32)
    got_v, got_i = tmc.grouped_codebook_topk(
        torch.from_numpy(z), tslab, 1, int(lengths[1]), k=k, stride=stride
    )
    assert got_v.shape == (5, k) and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=ATOL, rtol=0)
    assert tmc.grouped_codebook_topk.launches == 0


def test_grouped_topk_duplicate_rows_rank_lowest_index_first():
    cbs = _codebooks([700], seed=9, dups=[(0, 300, 20), (0, 300, 650)])
    slab, lengths = _slab(cbs)
    z = cbs[0][300:301].copy()
    _, idcs = tmc.grouped_codebook_topk(torch.from_numpy(z), torch.from_numpy(slab), 0, 700, k=3)
    assert idcs.numpy().tolist() == [[20, 300, 650]]


@pytest.mark.parametrize("k", [0, 33])
def test_grouped_topk_rejects_k_outside_1_to_32(k):
    cbs = _codebooks([300])
    slab, _ = _slab(cbs)
    z = torch.zeros((2, 32))
    with pytest.raises(ValueError):
        tmc.grouped_codebook_topk(z, torch.from_numpy(slab), 0, 300, k=k)
    with pytest.raises(ValueError):
        jmc.grouped_codebook_topk(jnp.zeros((2, 32)), jnp.asarray(slab), jnp.asarray(0), k=k)


def test_stack_codebooks_identical_to_jax():
    cbs = _codebooks([300, 2100, 5])
    for tile in (TILE, 2048):
        want_slab, want_len = jmc.stack_codebooks(cbs, tile_n=tile)
        got_slab, got_len = tmc.stack_codebooks(cbs, tile_n=tile)
        assert got_slab.dtype == want_slab.dtype and got_len.dtype == want_len.dtype
        np.testing.assert_array_equal(got_slab, want_slab)
        np.testing.assert_array_equal(got_len, want_len)


def test_multi_codebook_top1_matches_xla():
    cbs = _codebooks([300, 200, 250], seed=4)
    slab, lengths = jmc.stack_codebooks(cbs, tile_n=TILE)
    rng = np.random.RandomState(6)
    z = rng.randn(9, 32).astype(np.float32)
    obj_ids = np.array([2, 0, 1, 1, 2, 0, 0, 2, 1], np.int32)
    want_v, want_i = jmc.multi_codebook_top1_xla(
        jnp.asarray(z), jnp.asarray(slab), jnp.asarray(obj_ids), jnp.asarray(lengths)
    )
    got_v, got_i = tmc.multi_codebook_top1(torch.from_numpy(z), torch.from_numpy(slab), obj_ids, lengths)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=ATOL, rtol=0)
