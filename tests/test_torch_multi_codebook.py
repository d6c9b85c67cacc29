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
from augmentedautoencoder_torch.ops import _cuda
from augmentedautoencoder_torch.ops import multi_codebook as tmc

torch.set_num_threads(1)

ATOL = 1e-5
TILE = 256
# an H100's shared memory as cudaDeviceGetAttribute reports it: 228 KB per
# SM, 227 KB for one block, 1 KB reserved in each block
H100_SMEM = _cuda.SmemLimits(per_sm=233472, per_block=232448, reserved=1024)


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


# ------------------------------------------- the streaming kernel's host side
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [1, 3, 8, 24, 64, 65, 200])
@pytest.mark.parametrize("k", [1, 4, 8, 32])
def test_stream_plan_fits_the_card(dtype, b, k):
    """plan_topk_stream for the serving shapes (92,232 rows padded to
    94,208, latent 128; B up to 64 queries per block, more in chunks):
    whole 16 KB-ish tiles of a multiple of 32 rows, 2-4 ring stages, a
    persistent grid of 2 * 132 blocks that fits the SM's shared memory,
    and scratch for every block's list."""
    from augmentedautoencoder_torch.ops import _cuda

    elem = 2 if dtype == torch.bfloat16 else 4
    plan = _cuda.plan_topk_stream(b, 94208, 128, elem, k, 132, H100_SMEM)
    assert plan.rows_per_tile % 32 == 0 and plan.rows_per_tile * 128 * elem <= 16384
    assert 2 <= plan.stages <= 4 and _cuda.STREAM_BLOCKS_PER_SM == 2
    assert 2 * (plan.smem_bytes + 1024) <= 233472 and plan.smem_bytes <= 232448
    assert plan.smem_bytes == _cuda.stream_smem_bytes(
        plan.stages, plan.rows_per_tile, 128 * elem, min(b, _cuda.STREAM_Q), 128, k)
    assert plan.n_blocks == min(-(-94208 // plan.rows_per_tile), 2 * 132)
    assert plan.scratch_words == 2 * b * plan.n_blocks * k + 2 * b * k
    if b <= 8 and k <= 8:  # the serving recipes keep 4 stages in each block
        assert plan.stages == 4


def test_stream_plan_on_a_small_plane():
    from augmentedautoencoder_torch.ops import _cuda

    plan = _cuda.plan_topk_stream(8, 100, 128, 2, 8, 132, H100_SMEM)
    assert plan.n_blocks == 2  # never more blocks than tiles


@pytest.mark.parametrize("d, elem, b, k, fits", [
    (256, 4, 64, 32, False), (256, 4, 8, 8, True), (256, 2, 64, 32, False), (256, 2, 8, 8, True),
    (128, 4, 64, 32, True), (128, 2, 64, 32, True),
])
def test_stream_plan_refuses_what_does_not_fit(d, elem, b, k, fits):
    """Where 2 ring stages of 2 blocks do not fit an SM's shared memory the
    plan raises; it never falls back to fewer blocks per SM."""
    from augmentedautoencoder_torch.ops import _cuda

    if fits:
        assert _cuda.plan_topk_stream(b, 94208, d, elem, k, 132, H100_SMEM).stages >= 2
    else:
        with pytest.raises(ValueError, match="no 2-stage pipeline"):
            _cuda.plan_topk_stream(b, 94208, d, elem, k, 132, H100_SMEM)


def test_stream_plan_follows_the_device_limits():
    """The budget is read from the device: half an SM less the reserve, at
    most the opt-in limit of one block."""
    from augmentedautoencoder_torch.ops import _cuda

    small = _cuda.SmemLimits(per_sm=102400, per_block=101376, reserved=1024)
    assert _cuda.plan_topk_stream(8, 94208, 128, 2, 8, 132, small).stages == 2
    with pytest.raises(ValueError, match="no 2-stage pipeline"):
        _cuda.plan_topk_stream(64, 94208, 128, 2, 32, 132, small)


@pytest.mark.parametrize("d, dtype, ok", [
    (128, torch.bfloat16, True), (16, torch.bfloat16, True), (120, torch.bfloat16, False),
    (8, torch.bfloat16, False), (128, torch.float32, True), (4, torch.float32, True),
    (30, torch.float32, False), (250, torch.float32, False),
])
def test_stream_width_rule(d, dtype, ok):
    """Rows are copied in 16-byte pieces and bf16 rows scored in tensor-core
    steps of 16 columns: other widths are refused with the rule."""
    from augmentedautoencoder_torch.ops import _cuda

    if ok:
        _cuda.check_stream_width(d, dtype)
    else:
        with pytest.raises(ValueError, match=f"multiple of {16 if dtype == torch.bfloat16 else 4}"):
            _cuda.check_stream_width(d, dtype)


def test_stream_binding_refuses_cpu_tensors():
    from augmentedautoencoder_torch.ops import _cuda

    slab = torch.zeros((2, 256, 128))
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.codebook_topk_stream(torch.zeros((4, 128)), slab, 0, 256, 256, 1, 8)
