"""The port's ICP (augmentedautoencoder_torch/pose/icp.py) against the JAX
package's pose/icp.py, on the CPU, from the same numpy inputs.

Tolerances: one best fit at z ~ 700 mm agrees to atol 1e-4 (f32 sums in
another order); a whole ICP loop to T atol 1e-3 (the JAX package's own
bound for its kernel-vs-XLA loop test); a full 3-stage refinement from the
same seeded RandomState to t atol 0.1 mm and R atol 1e-3. On the JAX side
the loop's correspondence step is `batched_nn_pallas` in interpret mode,
as tests/test_icp_nn.py runs it.
"""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.geometry import transform
from augmentedautoencoder_tpu.ops.icp_nn import batched_nn_pallas
from augmentedautoencoder_tpu.pose import icp as jicp
from augmentedautoencoder_torch.pose import icp as ticp

torch.set_num_threads(1)


def random_cloud(n=500, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3) * 100.0).astype(np.float32)


def rigid_pair(seed, angle, axis, t, offset=(40.0, -30.0, 700.0), n=800):
    A = random_cloud(n, seed=seed) + np.asarray(offset, np.float32)
    R = transform.rotation_matrix(angle, axis)[:3, :3]
    return A.astype(np.float32), (A @ R.T + np.asarray(t)).astype(np.float32), R


@pytest.fixture(scope="module")
def jax_batch_pallas():
    """JAX icp_batch with its loop on batched_nn_pallas(interpret=True)."""

    def run(As, Bs, **kw):
        try:
            with mock.patch.object(
                jicp, "batched_nn_pallas", functools.partial(batched_nn_pallas, interpret=True)
            ):
                packed = np.asarray(jicp.icp_jax_batch(
                    jnp.asarray(As), jnp.asarray(Bs), nn_impl="pallas", **kw))
        finally:
            jicp.icp_jax_batch.clear_cache()  # later callers trace the real kernel again
        return [(p[:16].reshape(4, 4), float(p[16]), int(p[17])) for p in packed]

    return run


@pytest.mark.parametrize("mode", ["full", "depth_only", "no_depth"])
def test_best_fit_transform_matches_jax(mode):
    flags = {"depth_only": mode == "depth_only", "no_depth": mode == "no_depth"}
    A, B, _ = rigid_pair(1, 0.05, [1, 1, 0], [3.0, -2.0, 5.0])
    T, R, t = ticp.best_fit_transform(A, B, device="cpu", **flags)
    Tj, _, _ = jicp.best_fit_transform(A, B, **flags)
    np.testing.assert_allclose(T, Tj, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(T[3], [0, 0, 0, 1])
    if mode == "depth_only":
        np.testing.assert_array_equal(R, np.eye(3))
        assert t[0] == 0 and t[1] == 0
    if mode == "no_depth":
        assert t[2] == 0


@pytest.mark.parametrize("case", ["reflection", "planar", "proper"])
def test_kabsch_guard_matches_jax(case):
    rng = np.random.RandomState(3)
    H = rng.randn(3, 3).astype(np.float32)
    if case == "reflection":
        H = (H * np.sign(np.linalg.det(H))) @ np.diag([1, 1, -1]).astype(np.float32)
    elif case == "planar":
        H[:, 2] = 0.0  # rank 2: the Newton iteration cannot reach an orthogonal matrix
    else:
        H = H * np.sign(np.linalg.det(H))
    got = ticp._kabsch_rotation(torch.from_numpy(H)[None])[0].numpy()
    want = np.asarray(jicp._kabsch_rotation(jnp.asarray(H)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    if case == "proper":
        U, _, Vt = np.linalg.svd(H.astype(np.float64))
        np.testing.assert_allclose(got, Vt.T @ U.T, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, np.eye(3))


def test_converged_matches_jax():
    rng = np.random.RandomState(0)
    n, N = 6, 50
    prev_idx = rng.randint(0, N, (n, N)).astype(np.int32)
    idx = prev_idx.copy()
    idx[[0, 2, 4], 7] += 1  # lanes 1, 3, 5 at an index fixed point
    prev_err = np.array([1.0, 1.0, 2.0, 3.0, 0.5, 0.5], np.float32)
    mean_err = np.array([1.0 + 5e-7, 0.9, 1.5, 3.0, 0.45, 0.4], np.float32)
    tiny_T = np.eye(4, dtype=np.float32)
    tiny_T[:3, 3] = [0.001, 0.0, 0.002]
    big_T = np.eye(4, dtype=np.float32)
    big_T[:3, :3] = transform.rotation_matrix(0.01, [0, 0, 1])[:3, :3]
    Ts = np.stack([big_T, big_T, tiny_T, tiny_T, tiny_T, big_T])
    prev_tiny = np.array([False, True, True, False, False, True])
    got = ticp._converged(*(torch.from_numpy(a) for a in (prev_err, mean_err)), 1e-6,
                          torch.from_numpy(prev_idx), torch.from_numpy(idx),
                          torch.from_numpy(Ts), torch.from_numpy(prev_tiny))
    want = jicp._converged(jnp.asarray(prev_err), jnp.asarray(mean_err), 1e-6, jnp.asarray(prev_idx),
                           jnp.asarray(idx), jnp.asarray(Ts), jnp.asarray(prev_tiny))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # lane 0: error delta; lane 2: two tiny steps; lane 4: tiny after a big one
    np.testing.assert_array_equal(got[0].numpy(), [True, True, True, True, False, True])


@pytest.mark.parametrize("flags", [{}, {"depth_only": True}, {"no_depth": True}],
                         ids=["full", "depth_only", "no_depth"])
def test_icp_batch_matches_jax_pallas_loop(jax_batch_pallas, flags):
    rng = np.random.RandomState(5)
    A = rng.randn(2, 400, 3).astype(np.float32) * 50.0
    A[..., 2] += 700.0
    ang = 0.04
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    B = (A @ R.T + np.array([2.0, -1.0, 4.0], np.float32)).astype(np.float32)
    got = ticp.icp_batch(A, B, device="cpu", **flags)
    want = jax_batch_pallas(A, B, **flags)
    for (T, err, it), (Tj, errj, itj) in zip(got, want):
        np.testing.assert_allclose(T, Tj, atol=1e-3)
        np.testing.assert_allclose(err, errj, atol=1e-3)
        assert it < 100 and itj < 100


def test_icp_terminates_before_cap_at_camera_distance():
    """tests/test_pose.py:119: exact rigid pairs at z ~ 700 mm must stop well
    below the 100-iteration cap and recover the motion."""
    pairs = [rigid_pair(j, 0.02 + 0.03 * j, [1, 0, 1], np.array([1.5, -1.0, 2.0]) * (j + 1))
             for j in range(3)]
    fits = ticp.icp_batch(np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]),
                          tolerance=1e-9, device="cpu")
    for (T, err, iters), (_, _, R), j in zip(fits, pairs, range(3)):
        assert iters < 50, f"lane spun to {iters} iterations"
        np.testing.assert_allclose(T[:3, :3], R, atol=1e-3)
        np.testing.assert_allclose(T[:3, 3], np.array([1.5, -1.0, 2.0]) * (j + 1), atol=0.1)


def test_icp_batch_lanes_match_sequential():
    """tests/test_pose.py:188: lane i of the batched loop follows its own
    sequential run (frozen lanes), iteration counts equal."""
    As, Bs = [], []
    for j in range(3):
        A = random_cloud(500)
        R = transform.rotation_matrix(0.02 + 0.05 * j, [0, 1, 0])[:3, :3]
        As.append(A)
        Bs.append((A @ R.T + np.array([1.0, -2.0, 3.0]) * (j + 1)).astype(np.float32))
    got = ticp.icp_batch(np.stack(As), np.stack(Bs), tolerance=1e-7, device="cpu")
    for (T_b, err_b, it_b), A, B in zip(got, As, Bs):
        T_s, err_s, it_s = ticp.icp(A, B, tolerance=1e-7, device="cpu")
        np.testing.assert_allclose(T_b, T_s, atol=1e-4)
        np.testing.assert_allclose(err_b, err_s, atol=1e-3)
        assert it_b == it_s
        Tj, errj, itj = jicp.icp(A, B, tolerance=1e-7)
        np.testing.assert_allclose(T_b, Tj, atol=1e-3)


def test_done_check_interval_does_not_change_results(monkeypatch):
    A, B, _ = rigid_pair(2, 0.05, [0, 1, 1], [2.0, 1.0, -3.0], n=300)
    every = ticp.icp_batch(A[None], B[None], device="cpu")
    monkeypatch.setattr(ticp, "DONE_CHECK_EVERY", 1)
    once = ticp.icp_batch(A[None], B[None], device="cpu")
    np.testing.assert_array_equal(every[0][0], once[0][0])
    assert every[0][1:] == once[0][1:]


# ----------------------------------------------------------- refine_batch
K = np.array([[240.0, 0, 80.0], [0, 240.0, 60.0], [0, 0, 1.0]])
W, H = 160, 120


def _scene(renderer, t_gt):
    _, depth = renderer.render(0, W, H, K, np.eye(3), np.asarray(t_gt), 10, 10000, random_light=False)
    ys, xs = np.nonzero(depth > 0)
    cx, cy = (xs.min() + xs.max()) // 2, (ys.min() + ys.max()) // 2
    size = int(max(xs.max() - xs.min(), ys.max() - ys.min()) * 1.2)
    left, top = max(cx - size // 2, 0), max(cy - size // 2, 0)
    return depth[top:top + size, left:left + size], (left, top)


@pytest.fixture(scope="module")
def renderers(tmp_path_factory):
    from augmentedautoencoder_tpu.renderer import FakeRenderer
    from augmentedautoencoder_tpu.renderer import Renderer as JaxRenderer
    from augmentedautoencoder_torch.renderer import Renderer
    from augmentedautoencoder_torch.renderer.procedural import make_textured_asymmetric

    mesh = make_textured_asymmetric(subdivisions=2, radius=45.0)
    fake = FakeRenderer(object_radius=45.0)
    return {
        "fake": (fake, fake),
        "numpy": (Renderer([], backend="numpy", meshes=[mesh]),
                  JaxRenderer([], backend="numpy", meshes=[mesh])),
    }


@pytest.mark.parametrize("frame_accurate", [False, True], ids=["centred", "frame"])
@pytest.mark.parametrize("backend", ["fake", "numpy"])
def test_refine_batch_matches_jax(renderers, backend, frame_accurate):
    port_r, jax_r = renderers[backend]
    t_gts = [np.array([100.0, 8.0, 550.0]), np.array([-30.0, 20.0, 600.0])]
    crops, offsets = zip(*(_scene(port_r, t) for t in t_gts))
    R0s = [np.eye(3), transform.rotation_matrix(0.1, [0, 1, 0])[:3, :3]]
    t0s = [t + np.array([4.0, -3.0, 30.0]) for t in t_gts]
    kw = dict(class_name="obj", crop_offsets=list(offsets) if frame_accurate else None)
    port = ticp.ICP({"obj": ticp.SynRenderer(port_r)}, device="cpu")
    ref = jicp.ICP({"obj": jicp.SynRenderer(jax_r)})
    Rs, ts = port.refine_batch(list(crops), R0s, t0s, K, (W, H), rng=np.random.RandomState(0), **kw)
    Rj, tj = ref.refine_batch(list(crops), R0s, t0s, K, (W, H), rng=np.random.RandomState(0), **kw)
    np.testing.assert_allclose(ts, tj, atol=0.1, rtol=0)
    np.testing.assert_allclose(Rs, Rj, atol=1e-3, rtol=0)
    # and ICP helped: depth error shrank from 30 mm
    assert all(abs(t[2] - g[2]) < 30.0 for t, g in zip(ts, t_gts))


def test_refine_single_and_icp_refinement_match_jax(renderers):
    # the textured asymmetric mesh: a sphere leaves rotation-only ICP undetermined
    port_r, jax_r = renderers["numpy"]
    crop, _ = _scene(port_r, [0.0, 0.0, 700.0])
    _, depth = port_r.render(0, W, H, K, np.eye(3), np.array([0, 0, 700.0]), 10, 10000)
    R0, t0 = np.eye(3), np.array([0.0, 0.0, 640.0])
    R1, t1 = ticp.icp_refinement(depth, ticp.SynRenderer(port_r), R0, t0, K, (W, H), depth_only=True,
                                 rng=np.random.RandomState(0), device="cpu")
    Rj, tj = jicp.icp_refinement(depth, jicp.SynRenderer(jax_r), R0, t0, K, (W, H), depth_only=True,
                                 rng=np.random.RandomState(0))
    np.testing.assert_allclose(t1, tj, atol=0.1)
    np.testing.assert_array_equal(R1, R0)
    assert abs(t1[2] - 700.0) < abs(t0[2] - 700.0)
    np.random.seed(3)
    Rs, ts = ticp.ICP({"obj": ticp.SynRenderer(port_r)}, device="cpu").refine(crop, R0, t0, K, (W, H))
    np.random.seed(3)
    Rsj, tsj = jicp.ICP({"obj": jicp.SynRenderer(jax_r)}).refine(crop, R0, t0, K, (W, H))
    np.testing.assert_allclose(ts, tsj, atol=0.1)
    np.testing.assert_allclose(Rs, Rsj, atol=1e-3)


def test_rotation_jump_is_rejected():
    T = np.eye(4)
    T[:3, :3] = transform.rotation_matrix(np.radians(25.0), [0, 0, 1])[:3, :3]
    T[:3, 3] = [1.0, 2.0, 0.0]
    R_est, t_est = np.eye(3), np.array([0.0, 0.0, 500.0])
    for no_depth in (False, True):
        got = ticp._apply_refinement(T, R_est, t_est, no_depth=no_depth)
        want = jicp._apply_refinement(T, R_est, t_est, no_depth=no_depth)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(ticp._apply_refinement(T, R_est, t_est, no_depth=True)[1], t_est)
