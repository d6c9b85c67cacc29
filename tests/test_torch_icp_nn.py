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
