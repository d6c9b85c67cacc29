"""The port's row-sharded codebook queries (`ops.nn_query.make_cosine_top1_sharded`,
`make_cosine_topk_sharded`: each rank's block through B3 / B2's plain
versions on the CPU, the candidates all-gathered and ranked again) against
the JAX package's on a CPU mesh of the same size: indices equal, values
within 1e-6 (the bound of tests/test_training.py's sharded query), over
W in {2, 4} ranks joined by gloo; rows duplicated across shards return the
lowest global index; a bf16 codebook; rows sharded over the model axis;
a row count that does not divide by the ranks raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.ops.nn_query import (
    make_cosine_top1_sharded as jax_top1_sharded,
    make_cosine_topk_sharded as jax_topk_sharded,
)
from augmentedautoencoder_tpu.parallel import codebook_sharding as jax_codebook_sharding
from augmentedautoencoder_tpu.parallel import make_mesh as jax_make_mesh
from augmentedautoencoder_torch.parallel.dryrun import run_ranks

import _torch_ddp_ranks as ranks

VAL_ATOL = 1e-6
K = 8


def _codebook(n, d, seed, dup=None):
    rng = np.random.RandomState(seed)
    cb = rng.randn(n, d).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=1, keepdims=True)
    z = rng.randn(6, d).astype(np.float32)
    if dup is not None:
        for src, dst in dup:
            cb[dst] = cb[src]
        z[0] = cb[dup[0][0]] + 0.01 * rng.randn(d).astype(np.float32)
    return cb, z


def _jax(cb, z, world, axis="data", dtype=jnp.float32):
    if axis == "data":
        mesh = jax_make_mesh(jax.devices()[:world])
    else:
        mesh = jax_make_mesh(jax.devices()[:world], data=1, model=world)
    cbs = jax.device_put(jnp.asarray(cb, dtype), jax_codebook_sharding(mesh, shard_rows=True, axis=axis))
    v1, i1 = jax_top1_sharded(mesh, axis=axis)(jnp.asarray(z), cbs)
    vk, ik = jax_topk_sharded(mesh, K, axis=axis)(jnp.asarray(z), cbs)
    return [np.asarray(a) for a in (v1, i1, vk, ik)]


def _check(got, want, world):
    v1, i1, vk, ik = want
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["top1"][1].numpy(), i1, err_msg=f"rank {r} top-1 indices")
        np.testing.assert_array_equal(g["topk"][1].numpy(), ik, err_msg=f"rank {r} top-k indices")
        np.testing.assert_allclose(g["top1"][0].numpy(), v1, atol=VAL_ATOL, rtol=0)
        np.testing.assert_allclose(g["topk"][0].numpy(), vk, atol=VAL_ATOL, rtol=0)
        assert g["top1"][1].dtype == g["topk"][1].dtype == torch.int32


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_queries_match_jax(world):
    cb, z = _codebook(64 * world, 16, seed=world)
    got = run_ranks(ranks.sharded_query, world, "cpu", cb, z, K, "data")
    assert [g["block_rows"] for g in got] == [64] * world
    _check(got, _jax(cb, z, world), world)


@pytest.mark.parametrize("world", [2, 4])
def test_rows_duplicated_across_shards_return_the_lowest_index(world):
    """Rows 5 and 9 copied into the last shard: the query near row 5 ties
    the copies, and every tie goes to the lower global row, as the JAX
    docstring says and lax.top_k over the whole matrix does."""
    n = 32 * world
    cb, z = _codebook(n, 16, seed=10 + world, dup=[(5, n - 3), (9, n - 1), (5, n - 2)])
    got = run_ranks(ranks.sharded_query, world, "cpu", cb, z, K, "data")
    want = _jax(cb, z, world)
    _check(got, want, world)
    assert int(want[1][0]) == 5 and list(want[3][0][:3]) == [5, n - 3, n - 2]


def test_bf16_codebook_matches_jax():
    world = 2
    cb, z = _codebook(64 * world, 16, seed=3)
    cb_bf16 = torch.from_numpy(cb).to(torch.bfloat16)
    got = run_ranks(ranks.sharded_query, world, "cpu", cb_bf16, z, K, "data")
    _check(got, _jax(cb_bf16.float().numpy(), z, world, dtype=jnp.bfloat16), world)


def test_rows_sharded_over_the_model_axis_match_jax():
    world = 2
    cb, z = _codebook(48 * world, 16, seed=4)
    got = run_ranks(ranks.sharded_query, world, "cpu", cb, z, K, "model", world)
    _check(got, _jax(cb, z, world, axis="model"), world)


def test_rows_that_do_not_divide_by_the_ranks_raise():
    got = run_ranks(ranks.sharded_rows_error, 2, "cpu", 129)
    assert all("129 does not divide into 2 shards" in g for g in got)
    with pytest.raises(ValueError):  # as JAX's placement of the same layout
        jax.device_put(np.zeros((129, 16), np.float32),
                       jax_codebook_sharding(jax_make_mesh(jax.devices()[:2]), shard_rows=True, axis="data"))
