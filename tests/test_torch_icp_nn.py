"""The port's ICP nearest neighbour (augmentedautoencoder_torch/ops/icp_nn.py)
against the JAX package's `batched_nn_pallas` (Pallas interpret mode on the
CPU) and `batched_nn_xla`, on the cases of tests/test_icp_nn.py.

Indices must be equal. Distances only feed ICP's convergence mean; the
three implementations cancel |d|^2 - 2 s.d in different orders, so near-zero
distances carry a few microns of absolute wobble: rtol 1e-2 / atol 5e-3,
the JAX test's own tolerance. The CUDA kernel itself is held against
`batched_nn_torch` on the card by chip_smoke.py phase 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.ops.icp_nn import batched_nn_pallas, batched_nn_xla
from augmentedautoencoder_torch.ops import icp_nn

torch.set_num_threads(1)


def clouds(n, N, seed=0, scale=60.0, z=700.0):
    """Object-radius-scale clouds at camera distance, like real ICP input."""
    rng = np.random.RandomState(seed)
    src = rng.randn(n, N, 3).astype(np.float32) * scale
    dst = rng.randn(n, N, 3).astype(np.float32) * scale
    src[..., 2] += z
    dst[..., 2] += z
    return src, dst


def tie_case():
    # dst holds an exact duplicate point: the lower index (2) must win
    src = np.zeros((1, 8, 3), np.float32)
    dst = np.ones((1, 8, 3), np.float32) * 5.0
    dst[0, 2] = [1.0, 0.0, 0.0]
    dst[0, 6] = [1.0, 0.0, 0.0]
    return src, dst


def far_case():
    # N = 1025: the TPU kernel pads 1023 dst columns; here a tail tile
    rng = np.random.RandomState(4)
    return (rng.randn(2, 1025, 3).astype(np.float32) * 1000.0,
            rng.randn(2, 1025, 3).astype(np.float32) * 1000.0)


CASES = {
    "production_n3_N3000": lambda: clouds(3, 3000, seed=1),
    "small_single_tile": lambda: clouds(2, 100, seed=2),
    "single_lane": lambda: clouds(1, 1500, seed=3),
    "tie": tie_case,
    "tail_1025": far_case,
}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_nn_torch_matches_jax(case):
    src, dst = CASES[case]()
    dist, idx = icp_nn.batched_nn_torch(torch.from_numpy(src), torch.from_numpy(dst))
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    dist_x, idx_x = batched_nn_xla(jnp.asarray(src), jnp.asarray(dst))
    dist_p, idx_p = batched_nn_pallas(jnp.asarray(src), jnp.asarray(dst), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_p))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_x))
    for want in (dist_p, dist_x):
        np.testing.assert_allclose(dist.numpy(), np.asarray(want), rtol=1e-2, atol=5e-3)
    if case == "tie":
        assert np.all(idx.numpy() == 2)
        np.testing.assert_allclose(dist.numpy(), 1.0, atol=1e-5)
    assert idx.numpy().max() < src.shape[1]


def test_batched_nn_is_exact_brute_force():
    """Against float64 brute force: the nearest point up to f32 ties."""
    src, dst = clouds(2, 300, seed=7)
    dist, idx = icp_nn.batched_nn_torch(torch.from_numpy(src), torch.from_numpy(dst))
    d2 = ((src[:, :, None].astype(np.float64) - dst[:, None].astype(np.float64)) ** 2).sum(-1)
    best = d2.min(-1)
    got = np.take_along_axis(d2, idx.numpy().astype(np.int64)[..., None], -1)[..., 0]
    np.testing.assert_allclose(got, best, rtol=0, atol=1e-2)  # f32 score resolution at ~60 mm
    np.testing.assert_allclose(dist.numpy(), np.sqrt(best), rtol=1e-4, atol=5e-3)


def test_blocking_does_not_change_results(monkeypatch):
    src, dst = clouds(5, 200, seed=8)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    whole = icp_nn.batched_nn_torch(s, d)
    monkeypatch.setattr(icp_nn, "_SCORE_BLOCK", 37 * 200)  # 37 source points per block, a ragged tail
    chunked = icp_nn.batched_nn_torch(s, d)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


def test_wrapper_takes_the_plain_route_on_cpu(monkeypatch):
    src, dst = clouds(2, 100, seed=2)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)

    def no_kernel(*_):
        raise AssertionError("the CUDA route was taken for CPU tensors")

    monkeypatch.setattr(icp_nn, "batched_nn_cuda", no_kernel)
    got = icp_nn.batched_nn(s, d)
    want = icp_nn.batched_nn_torch(s, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrapper_rejects_other_devices_and_bad_input():
    src, dst = clouds(1, 10)
    s = torch.from_numpy(src)
    with pytest.raises(ValueError, match="unsupported devices"):
        icp_nn.batched_nn(s.to("meta"), s.to("meta"))
    with pytest.raises(ValueError, match="f32"):
        icp_nn.batched_nn(s.double(), s.double())
    with pytest.raises(ValueError, match=r"\(n, N, 3\)"):
        icp_nn.batched_nn(s, s[:, :5])


# ---------------------------------------------------------------- tree_mean
@pytest.mark.parametrize("N", [1, 7, 1025, 3000])
def test_tree_mean_is_tree_sum_times_the_f32_reciprocal(N):
    """One multiply by the f32 reciprocal of the count, the operation CUDA's
    x / n computes: numpy's f32 product of the same sum gives the same bits."""
    src, _ = clouds(3, N, seed=N)
    x = torch.from_numpy(src)
    total = icp_nn.tree_sum(x, 1)
    want = total.numpy() * (np.float32(1.0) / np.float32(N))
    assert np.array_equal(icp_nn.tree_mean(x, 1).numpy(), want)
    assert icp_nn.recip_f32(N) == float(np.float32(1.0) / np.float32(N)) == float(np.float32(1.0 / N))


def test_tree_mean_differs_from_division_where_the_devices_did():
    """The repaired rounding is not a no-op on the CPU: on the loop's (8, 3000)
    shape, dividing by N (the CPU's former result) and multiplying by the
    reciprocal (the GPU's) round some centroids apart."""
    x = torch.from_numpy(clouds(64, 3000, seed=11)[0])
    total = icp_nn.tree_sum(x, 1)
    assert not torch.equal(total / 3000, icp_nn.tree_mean(x, 1))


# --------------------------------------------- the fused kernel's merge rule
def _key(score):
    """csrc/icp_nn.cu nn_key's high word: float order as unsigned order,
    -0.0 keyed as +0.0."""
    u = np.asarray(score, np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(u == 0x80000000, 0, u)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _unkey(k):
    u = np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k & 0xFFFFFFFF)
    return u.astype(np.uint32).view(np.float32)


def keyed_split_min(scores, split_len):
    """Plain emulation of aae_batched_nn's merge: each split of the
    destinations keeps its first minimum (torch.min), then the splits meet
    in a 64-bit min of (key(score) << 32 | j) in any order (here: last split
    first). scores: (n, N_src, N_dst) f32 tensor -> (min, argmin)."""
    n, n_src, n_dst = scores.shape
    keys = np.full((n, n_src), np.iinfo(np.uint64).max, np.uint64)
    for j0 in reversed(range(0, n_dst, split_len)):
        v, j = torch.min(scores[..., j0: j0 + split_len], dim=-1)
        k = (_key(v.numpy()) << np.uint64(32)) | (j.numpy() + j0).astype(np.uint64)
        keys = np.minimum(keys, k)
    return _unkey(keys >> np.uint64(32)), (keys & np.uint64(0xFFFFFFFF)).astype(np.int32)


def test_key_orders_like_floats_and_equates_signed_zeros():
    vals = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf], np.float32)
    keys = _key(vals)
    assert np.all(np.diff(keys.astype(np.float64)[[0, 1, 2, 4, 5, 6, 7]]) > 0)
    assert keys[3] == keys[4]
    assert np.array_equal(_unkey(keys)[[0, 1, 2, 5, 6, 7]], vals[[0, 1, 2, 5, 6, 7]])


@pytest.mark.parametrize("case", ["ties_straddle_split", "signed_zeros", "N1", "N_below_tile"])
def test_split_merge_equals_the_unsplit_first_minimum(case):
    rng = np.random.RandomState(3)
    if case == "ties_straddle_split":
        # each row's minimum repeated on both sides of every split boundary
        scores = rng.randn(2, 5, 40).astype(np.float32)
        scores[..., [9, 10, 19, 20, 30]] = -7.0
        split_len = 10
    elif case == "signed_zeros":
        # -0.0 before +0.0 and +0.0 before -0.0, in different splits
        scores = np.abs(rng.randn(1, 4, 12)).astype(np.float32) + 1.0
        scores[0, 0, [2, 8]] = [-0.0, 0.0]
        scores[0, 1, [3, 7]] = [0.0, -0.0]
        scores[0, 2, [5, 6]] = [-0.0, -0.0]
        split_len = 4
    elif case == "N1":
        scores, split_len = rng.randn(3, 1, 1).astype(np.float32), 1
    else:
        scores, split_len = rng.randn(2, 3, 7).astype(np.float32), 64
    t = torch.from_numpy(scores)
    want_v, want_i = torch.min(t, dim=-1)
    got_v, got_i = keyed_split_min(t, split_len)
    assert np.array_equal(got_i, want_i.numpy())
    assert np.array_equal(got_v, want_v.numpy())  # value equality: -0.0 == +0.0
    if case == "signed_zeros":
        assert got_i[0].tolist()[:3] == [2, 3, 5]


@pytest.mark.parametrize("n, N", [(8, 3000), (3, 1025), (2, 100)])
def test_split_merge_of_the_plain_scores_equals_min_argmin_torch(n, N):
    """The plain version's scores, split as the kernel splits them at this
    shape on a 132-SM card: the same indices, the same distances bit for bit."""
    from augmentedautoencoder_torch.ops import _cuda

    src, dst = clouds(n, N, seed=N)
    s, sp, d, dsq = icp_nn._operands(torch.from_numpy(src), torch.from_numpy(dst))
    want_min, want_idx = icp_nn.min_argmin_torch(sp, d, dsq)
    scores = sp[..., 0, None] * d[:, None, :, 0]
    scores += sp[..., 1, None] * d[:, None, :, 1]
    scores += sp[..., 2, None] * d[:, None, :, 2]
    scores += dsq[:, None, :]
    split_len, splits = _cuda.plan_nn(n, N, 132)
    assert splits > 1
    got_min, got_idx = keyed_split_min(scores, split_len)
    assert np.array_equal(got_idx, want_idx.numpy())
    assert torch.equal(icp_nn._distances(s, torch.from_numpy(got_min)), icp_nn._distances(s, want_min))


@pytest.mark.parametrize("n", [1, 2, 3, 8, 16, 24])
@pytest.mark.parametrize("N", [1, 7, 1000, 1025, 2999, 3000, 20001])
def test_nn_plan_covers_the_destinations(n, N):
    """plan_nn for the ICP loop's lane counts and N_SUB = 3000 (and edge
    sizes): splits of at most 2048 points, about 64 or more, that cover N
    exactly once, and about
    NN_BLOCKS_PER_SM blocks per SM when the points allow it."""
    from augmentedautoencoder_torch.ops import _cuda

    sms = 132
    split_len, splits = _cuda.plan_nn(n, N, sms)
    assert 1 <= split_len <= 2048 and 1 <= splits <= 65535
    assert (splits - 1) * split_len < N <= splits * split_len
    assert splits <= -(-N // 64)  # no split much shorter than 64 points
    blocks = n * -(-N // _cuda.NN_SRC_PER_BLOCK) * splits
    if N >= 64 * 8:
        assert blocks >= min(_cuda.NN_BLOCKS_PER_SM * sms, n * -(-N // 1024) * (N // 64))
    assert blocks < 2 * _cuda.NN_BLOCKS_PER_SM * sms or splits == 1 or split_len == 2048  # tile cap


def test_cuda_binding_refuses_cpu_tensors():
    from augmentedautoencoder_torch.ops import _cuda

    src, dst = clouds(2, 10)
    with pytest.raises(ValueError, match="CUDA"):
        icp_nn.batched_nn_cuda(torch.from_numpy(src), torch.from_numpy(dst))
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.batched_nn(torch.from_numpy(src), torch.from_numpy(dst))


def test_sqrt_rn_is_correctly_rounded():
    """sqrt_rn, the square root of the plain B4 distances and of the ICP
    loop, equals numpy's correctly rounded f32 square root (as CUDA's and
    the kernel's __fsqrt_rn are), so the CPU port and the card agree on
    every distance; the plain distances are sqrt_rn of their clamped sums."""
    from augmentedautoencoder_torch.ops import icp_nn

    rng = np.random.RandomState(0)
    x = np.concatenate([rng.rand(400_000) * 10, rng.rand(400_000) * 1e6, rng.rand(1000) * 1e-30]).astype(np.float32)
    np.testing.assert_array_equal(icp_nn.sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))
    src = torch.from_numpy((rng.randn(2, 3000, 3) * 60 + [0, 0, 700]).astype(np.float32))
    dst = torch.from_numpy((rng.randn(2, 3000, 3) * 60 + [5, -3, 705]).astype(np.float32))
    dist, _ = icp_nn.batched_nn_torch(src, dst)
    s, sp, d, dsq = icp_nn._operands(src, dst)
    ms, _ = icp_nn.min_argmin_torch(sp, d, dsq)
    total = torch.clamp(icp_nn.sum3(s * s) + ms, min=0.0).numpy()
    np.testing.assert_array_equal(dist.numpy(), np.sqrt(total))
