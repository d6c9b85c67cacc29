"""The port's depth re-scoring (augmentedautoencoder_torch/pose/rescore.py)
against the JAX package's: same renders, so the same scores and picks,
exactly."""

import numpy as np
import pytest

from augmentedautoencoder_tpu.geometry import transform
from augmentedautoencoder_tpu.pose import rescore as jrescore
from augmentedautoencoder_torch.pose import rescore
from augmentedautoencoder_torch.renderer import Renderer
from augmentedautoencoder_torch.renderer.procedural import make_textured_asymmetric

K = np.array([[240.0, 0, 80.0], [0, 240.0, 60.0], [0, 0, 1.0]])
W, H = 160, 120


@pytest.fixture(scope="module")
def scene():
    renderer = Renderer([], backend="numpy", meshes=[make_textured_asymmetric(subdivisions=2, radius=45.0)])
    R_gt = transform.rotation_matrix(0.4, [0, 1, 0])[:3, :3]
    t_gt = np.array([10.0, -5.0, 550.0])
    _, depth = renderer.render(0, W, H, K, R_gt, t_gt, 10, 10000)
    rng = np.random.RandomState(0)
    B, k = 3, 4
    Rs = np.stack([[transform.random_rotation_matrix(rng.rand(3))[:3, :3] for _ in range(k)]
                   for _ in range(B)])
    ts = np.tile(t_gt, (B, k, 1)) + rng.randn(B, k, 3) * 5.0
    Rs[1, 2], ts[1, 2] = R_gt, t_gt  # the true pose, third-ranked for detection 1
    ts[2, 0] = [0.0, 0.0, -500.0]  # off-screen: scores -1
    return renderer, depth, Rs, ts


def test_scores_match_jax(scene):
    renderer, depth, Rs, ts = scene
    got = rescore.depth_hypothesis_scores(renderer, K, (W, H), depth, Rs.reshape(-1, 3, 3),
                                          ts.reshape(-1, 3))
    want = jrescore.depth_hypothesis_scores(renderer, K, (W, H), depth, Rs.reshape(-1, 3, 3),
                                            ts.reshape(-1, 3))
    np.testing.assert_array_equal(got, want)
    assert got.reshape(3, 4)[2, 0] == -1.0 and got.reshape(3, 4)[1, 2] == 1.0


@pytest.mark.parametrize("tau", [5.0, 20.0])
def test_picks_match_jax(scene, tau):
    renderer, depth, Rs, ts = scene
    best, scores = rescore.select_best_hypothesis(renderer, K, (W, H), depth, Rs, ts, tau=tau)
    jbest, jscores = jrescore.select_best_hypothesis(renderer, K, (W, H), depth, Rs, ts, tau=tau)
    np.testing.assert_array_equal(best, jbest)
    np.testing.assert_array_equal(scores, jscores)
    assert best[1] == 2
