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
    """Shapes where 2 ring stages of 64 queries' 32-row tiles do not fit
    beside 2 blocks per SM (`fits` False: D 256, B 64, k 32) are planned
    with smaller tiles (bf16: 16 rows) or fewer queries per block (f32: 32,
    two chunks), never with fewer blocks per SM; the plan's split of tiles
    and query chunks, merged as the kernel merges it, gives the plain
    version's top-k. Shapes that fit keep their launch shape."""
    from augmentedautoencoder_torch.ops import _cuda

    plan = _cuda.plan_topk_stream(b, 94208, d, elem, k, 132, H100_SMEM)
    assert plan.stages >= 2 and 2 * (plan.smem_bytes + 1024) <= 233472
    if fits:
        assert plan.q_per_block == min(b, _cuda.STREAM_Q) and plan.rows_per_tile % 32 == 0
        return
    assert (plan.rows_per_tile, plan.q_per_block) == ((16, 64) if elem == 2 else (32, 32))
    dtype = torch.bfloat16 if elem == 2 else torch.float32
    _split_matches_plain(b, d, k, dtype, n_rows=3000, stride=1)


def test_stream_plan_follows_the_device_limits():
    """The budget is read from the device: half an SM less the reserve, at
    most the opt-in limit of one block. On a card with half the H100's
    shared memory the plan takes smaller tiles and fewer queries per block;
    it raises only where one query of 16-row tiles does not fit."""
    from augmentedautoencoder_torch.ops import _cuda

    small = _cuda.SmemLimits(per_sm=102400, per_block=101376, reserved=1024)
    assert _cuda.plan_topk_stream(8, 94208, 128, 2, 8, 132, small).stages == 2
    plan = _cuda.plan_topk_stream(64, 94208, 128, 2, 32, 132, small)
    assert plan.stages >= 2 and plan.q_per_block < 64
    assert 2 * (plan.smem_bytes + 1024) <= 102400
    tiny = _cuda.SmemLimits(per_sm=16384, per_block=16384, reserved=1024)
    with pytest.raises(ValueError, match="no 2-stage pipeline"):
        _cuda.plan_topk_stream(64, 94208, 256, 4, 32, 132, tiny)


def blocked_topk(scores, n_rows, k, rows_per_tile, n_blocks, q_per_block):
    """Plain model of aae_codebook_topk_stream's split and merge: queries in
    chunks of q_per_block; in each chunk tile t goes to block t % n_blocks,
    whose list keeps the k best (value desc, index asc) of its rows; the
    merge takes the k best of all blocks' lists. scores: (B, n_rows) f32
    numpy, masked rows already -2. Returns (values, indices) (B, k)."""
    b = scores.shape[0]
    n_tiles = -(-n_rows // rows_per_tile)
    vals, idcs = np.empty((b, k), np.float32), np.empty((b, k), np.int64)
    for q0 in range(0, b, q_per_block):
        for q in range(q0, min(b, q0 + q_per_block)):
            parts = []
            for blk in range(n_blocks):
                cols = np.concatenate([np.arange(t * rows_per_tile, min((t + 1) * rows_per_tile, n_rows))
                                       for t in range(blk, n_tiles, n_blocks)] or [np.zeros(0, np.int64)])
                order = np.lexsort((cols, -scores[q, cols]))[:k]
                parts.append(cols[order])
            cand = np.concatenate(parts)
            best = cand[np.lexsort((cand, -scores[q, cand]))[:k]]
            vals[q], idcs[q] = scores[q, best], best
    return vals, idcs


def _split_matches_plain(b, d, k, dtype, n_rows, stride):
    """The top-k plan for (b, d, k, dtype) on an n_rows plane, run through
    `blocked_topk` on the plain version's masked scores, with each query's
    best row copied into other blocks at lower and higher indices: equal to
    grouped_codebook_topk_plain, indices and values."""
    from augmentedautoencoder_torch.ops import _cuda

    elem = 2 if dtype == torch.bfloat16 else 4
    plan = _cuda.plan_topk_stream(b, n_rows, d, elem, k, 132, H100_SMEM)
    assert plan.n_blocks > 1
    rng = np.random.RandomState(d + b + k)
    cb = rng.randn(n_rows, d).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=1, keepdims=True)
    z = rng.randn(b, d).astype(np.float32)
    z[: b // 2] = cb[rng.randint(0, n_rows, b // 2)]
    for j, row in enumerate((72, 720, 1440)):  # ties across blocks, on the stride
        cb[row + 180] = cb[row]
        z[j] = cb[row]
    slab = torch.from_numpy(cb[None]).to(dtype)
    zt = torch.from_numpy(z)
    want_v, want_i = tmc.grouped_codebook_topk_plain(zt, slab, 0, n_rows - 3, k=k, stride=stride)
    scores = tmc._masked_cos(zt, slab, 0, n_rows - 3, stride).numpy()
    got_v, got_i = blocked_topk(scores, n_rows, k, plan.rows_per_tile, plan.n_blocks, plan.q_per_block)
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_v, want_v.numpy())
    return plan


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


# ------------------------------------------- latent widths the kernels pad
@pytest.mark.parametrize("d", [100, 102])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("fn", ["top1", "topk"])
def test_padded_width_matches_pallas(fn, bf16, d):
    """A slab stored with zero columns up to the kernels' width
    (`pad_slab`: 100 stays 100 in f32, 102 -> 104; both -> 112 in bf16)
    and unpadded queries give the JAX functions' results on the unpadded
    slab: zero columns add exact zeros."""
    cbs = _codebooks([600, 900], d=d, seed=d, dups=[(1, 4, 256), (1, 8, 512)])
    slab, lengths = _slab(cbs)
    z = np.random.RandomState(d).randn(6, d).astype(np.float32)
    z[0] = cbs[1][4]
    jslab = jnp.asarray(slab, jnp.bfloat16 if bf16 else jnp.float32)
    dtype = torch.bfloat16 if bf16 else torch.float32
    padded = tmc.pad_slab(torch.from_numpy(slab).to(dtype))
    assert padded.shape == slab.shape[:2] + (_cuda.stream_width(d, dtype),)
    assert padded.shape[-1] % (16 if bf16 else 4) == 0 and padded.shape[-1] - d < (16 if bf16 else 4)
    assert not padded[..., d:].any()
    args = (jnp.asarray(z), jslab, jnp.asarray(1, jnp.int32), jnp.asarray(lengths[1], jnp.int32))
    if fn == "top1":
        want_v, want_i = _interpret(jmc.grouped_codebook_top1, *args, tile_n=TILE)
        got_v, got_i = tmc.grouped_codebook_top1(torch.from_numpy(z), padded, 1, int(lengths[1]))
    else:
        want_v, want_i = _interpret(jmc.grouped_codebook_topk, *args, k=8, stride=4, tile_n=TILE)
        got_v, got_i = tmc.grouped_codebook_topk(torch.from_numpy(z), padded, 1, int(lengths[1]), k=8, stride=4)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=ATOL, rtol=0)


def test_pad_slab_keeps_a_slab_of_the_kernels_width():
    slab = torch.zeros((2, 256, 128), dtype=torch.bfloat16)
    assert tmc.pad_slab(slab) is slab


# ------------------------------------------- the streaming top-1's host side
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [8, 64])
@pytest.mark.parametrize("d", [128, 256])
def test_top1_plan_fits_the_card(dtype, b, d):
    """plan_top1_stream at the serving shapes (94,208 rows): tiles of a
    multiple of 32 rows, 2-4 ring stages, two blocks per SM in the H100's
    shared memory, at most TOP1_PAIRS running pairs a thread and a
    persistent grid of 2 * 132 blocks per query chunk."""
    elem = 2 if dtype == torch.bfloat16 else 4
    p = _cuda.plan_top1_stream(b, 94208, d, elem, 132, H100_SMEM)
    assert p.rows_per_tile % 32 == 0 and 2 <= p.stages <= 4
    assert 2 * (p.smem_bytes + 1024) <= 233472 and p.smem_bytes <= 232448
    assert p.smem_bytes == _cuda.top1_smem_bytes(p.stages, p.rows_per_tile, d * elem, p.q_per_block, d)
    assert p.qpt == (2 if p.q_per_block <= 8 else 8)
    if elem == 2:
        slots = -(-(p.rows_per_tile // 16) * -(-p.q_per_block // 8) // 8)
        assert slots * 2 <= _cuda.TOP1_PAIRS
    else:
        slots = -(-p.rows_per_tile * -(-p.q_per_block // p.qpt) // 256)
        assert slots * p.qpt <= _cuda.TOP1_PAIRS
    assert p.n_blocks == min(-(-94208 // p.rows_per_tile), 2 * 132)
    assert p.q_per_block == min(b, _cuda.TOP1_Q) or d == 256
    if b == 8:  # the serving shape: one chunk, ~32 KB tiles, 3 stages
        assert p.q_per_block == 8 and p.stages == 3 and p.rows_per_tile * d * elem == 32768


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [1, 3, 8, 24, 64, 65, 200])
def test_top1_plan_serves_every_width_the_first_design_served(dtype, b):
    """The first design served every latent width up to 256 at any B: the
    plan never raises there (widths padded to the kernels' step)."""
    elem = 2 if dtype == torch.bfloat16 else 4
    for d in range(1, 257):
        w = _cuda.stream_width(d, dtype)
        p = _cuda.plan_top1_stream(b, 92232, w, elem, 132, H100_SMEM)
        assert p.stages >= 2 and 2 * (p.smem_bytes + 1024) <= 233472


def test_top1_plan_takes_fewer_queries_where_the_ring_does_not_fit():
    """D 256 in f32 at B 64: two stages do not fit beside 64 queries, so the
    top-1 plan takes 32 queries per block (two chunks); so does the top-k
    plan at k 32 (B2's width repair), with 32-row tiles."""
    p = _cuda.plan_top1_stream(64, 94208, 256, 4, 132, H100_SMEM)
    assert (p.q_per_block, p.stages, p.rows_per_tile) == (32, 2, 32)
    t = _cuda.plan_topk_stream(64, 94208, 256, 4, 32, 132, H100_SMEM)
    assert (t.q_per_block, t.stages, t.rows_per_tile) == (32, 2, 32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [1, 3, 8, 24, 64, 65, 200])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_stream_plan_serves_every_width_the_jax_package_serves(dtype, b, k):
    """grouped_codebook_topk serves every latent width up to 256: the top-k
    plan never raises there (widths padded to the kernels' step), keeps two
    blocks per SM, tiles of a multiple of 16 rows (of 32 where it did not
    have to shrink them) and at most STREAM_Q queries per block."""
    elem = 2 if dtype == torch.bfloat16 else 4
    for d in range(1, 257):
        w = _cuda.stream_width(d, dtype)
        p = _cuda.plan_topk_stream(b, 92232, w, elem, k, 132, H100_SMEM)
        assert p.stages >= 2 and 2 * (p.smem_bytes + 1024) <= 233472
        assert p.rows_per_tile % _cuda.STREAM_MIN_ROWS == 0 and 1 <= p.q_per_block <= min(b, _cuda.STREAM_Q)
        assert p.smem_bytes == _cuda.stream_smem_bytes(p.stages, p.rows_per_tile, w * elem, p.q_per_block, w, k)


@pytest.mark.parametrize("case", [(256, 64, 32, "f32", 1), (256, 64, 32, "bf16", 1), (256, 65, 32, "f32", 36),
                                  (240, 200, 32, "f32", 1), (128, 8, 8, "bf16", 1)],
                         ids=["d256_b64_f32", "d256_b64_bf16", "d256_b65_stride36", "d240_b200", "serving"])
def test_stream_split_merge_equals_plain_topk(case):
    """The kernel's split at its plan (query chunks, tiles dealt to blocks,
    per-block lists, the merge) equals the plain top-k, ties included, at
    the repaired wide shapes and at the serving shape."""
    d, b, k, dt, stride = case
    plan = _split_matches_plain(b, d, k, torch.bfloat16 if dt == "bf16" else torch.float32, 2000, stride)
    if d == 256 and dt == "f32":
        assert -(-b // plan.q_per_block) > -(-b // _cuda.STREAM_Q)  # more chunks than ceil(B / 64)


def test_top1_binding_refuses_cpu_tensors():
    slab = torch.zeros((2, 256, 128))
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.codebook_top1_stream(torch.zeros((4, 128)), slab, 0, 256, 256)


# ------------------------------------------- the streaming top-1's merge rule
def _top1_key(v, i):
    """csrc/codebook_query.cu top1_key: the value's bits in float order
    (-0.0 keyed as +0.0) above the complemented index."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(u == 0x80000000, 0, u)
    hi = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return (hi << np.uint64(32)) | (~np.asarray(i, np.uint64) & np.uint64(0xFFFFFFFF))


def _top1_unkey(key):
    hi = key >> np.uint64(32)
    u = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi & 0xFFFFFFFF)
    idx = (~key & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return u.astype(np.uint32).view(np.float32), idx


def keyed_block_top1(scores, n_valid, rows_per_tile, n_blocks):
    """Plain model of aae_codebook_top1_stream's split and merge: rows >=
    n_valid score -2; tile t goes to block t % n_blocks; each block keeps
    the first maximum of its rows (the threads' running pairs and the
    block's reduction order by (value desc, index asc)), keyed; the blocks
    meet in a maximum of keys in any order (here the last block first).
    scores: (B, n_rows) f32 tensor -> (values, indices)."""
    b, n_rows = scores.shape
    col = torch.arange(n_rows)
    masked = torch.where(col[None] < n_valid, scores, torch.full_like(scores, -2.0))
    n_tiles = -(-n_rows // rows_per_tile)
    keys = np.zeros(b, np.uint64)
    for blk in reversed(range(n_blocks)):
        cols = torch.cat([col[t * rows_per_tile:(t + 1) * rows_per_tile] for t in range(blk, n_tiles, n_blocks)])
        sub = masked[:, cols]
        j = torch.argmax(sub, dim=1)
        v = torch.gather(sub, 1, j[:, None])[:, 0]
        keys = np.maximum(keys, _top1_key(v.numpy(), cols[j].numpy()))
    return _top1_unkey(keys)


def test_top1_key_orders_like_the_first_maximum_and_round_trips():
    vals = np.array([-np.inf, -2.0, -1e-30, -0.0, 0.0, 1e-30, 0.5, 1.0, np.inf], np.float32)
    keys = _top1_key(vals, np.full(len(vals), 7))
    assert np.all(np.diff(keys[[0, 1, 2, 4, 5, 6, 7, 8]].astype(np.float64)) > 0)
    assert keys[3] == keys[4]  # -0.0 and +0.0 are equal, as argmax has them
    # among equal values the lower index has the larger key
    assert _top1_key(np.float32(0.25), 3) > _top1_key(np.float32(0.25), 4) > _top1_key(np.float32(0.2), 0)
    idx = np.array([0, 1, 5, 92231, 2**31 - 1, 17, 3, 2, 1])
    got_v, got_i = _top1_unkey(_top1_key(vals, idx))
    assert np.array_equal(got_i, idx)
    assert np.array_equal(got_v, vals)  # -0.0 comes back as +0.0, which equals it
    assert np.array_equal(np.signbit(got_v), np.signbit(vals) & (vals != 0))


@pytest.mark.parametrize("case", ["dups_straddle_blocks", "signed_zeros", "masked_block", "ragged_tail",
                                  "plain_scores_at_the_plan"])
def test_top1_split_merge_equals_the_unsplit_first_maximum(case):
    rng = np.random.RandomState(7)
    n_valid = None
    if case == "dups_straddle_blocks":
        # each row's maximum repeated in several blocks, on both sides of tile edges
        scores = rng.uniform(-1, 0.5, (3, 640)).astype(np.float32)
        scores[:, [31, 32, 95, 96, 600]] = 0.9
        scores[1, [5, 37]] = 0.95  # block 0 and block 1 hold the tie
        rows, blocks = 32, 4
    elif case == "signed_zeros":
        # -0.0 before +0.0 and +0.0 before -0.0, in different blocks
        scores = -np.abs(rng.randn(3, 256)).astype(np.float32) - 0.1
        scores[0, [40, 100]] = [-0.0, 0.0]
        scores[1, [33, 200]] = [0.0, -0.0]
        scores[2, [70, 71]] = [-0.0, -0.0]
        rows, blocks = 32, 3
    elif case == "masked_block":
        # every true score negative; block 3's tiles all lie at or past n_valid
        scores = -rng.uniform(0.1, 1.0, (4, 640)).astype(np.float32)
        scores[:, 96:] = 5.0  # what masked rows hold must not matter
        n_valid, rows, blocks = 96, 32, 4
    elif case == "ragged_tail":
        scores = rng.randn(2, 75).astype(np.float32)
        scores[:, 70] = 9.0
        rows, blocks = 32, 3
    else:
        # the f32 plan's tiles and blocks on a 132-SM card for this plane
        d, n = 100, 5000
        cb = rng.randn(n, d).astype(np.float32)
        cb /= np.linalg.norm(cb, axis=1, keepdims=True)
        cb[4000] = cb[10]
        z = rng.randn(8, d).astype(np.float32)
        z[0] = cb[10]
        scores = z / np.linalg.norm(z, axis=1, keepdims=True) @ cb.T
        n_valid = 4999
        plan = _cuda.plan_top1_stream(8, n, _cuda.stream_width(d, torch.float32), 4, 132, H100_SMEM)
        rows, blocks = plan.rows_per_tile, plan.n_blocks
        assert blocks > 1
    t = torch.from_numpy(scores)
    n_valid = t.shape[1] if n_valid is None else n_valid
    col = torch.arange(t.shape[1])
    masked = torch.where(col[None] < n_valid, t, torch.full_like(t, -2.0))
    want_i = torch.argmax(masked, dim=1)
    want_v = torch.gather(masked, 1, want_i[:, None])[:, 0]
    got_v, got_i = keyed_block_top1(t, n_valid, rows, blocks)
    assert np.array_equal(got_i, want_i.numpy())
    assert np.array_equal(got_v, want_v.numpy())  # value equality: -0.0 == +0.0
    if case == "signed_zeros":
        assert got_i.tolist() == [40, 33, 70]
    if case == "dups_straddle_blocks":
        assert got_i.tolist() == [31, 5, 31]
    if case == "plain_scores_at_the_plan":
        assert got_i[0] == 10
