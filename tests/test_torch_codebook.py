"""Port Codebook vs the JAX Codebook on one params / codebook pair.

Both encode the same uint8 crops with the same Flax weights (the port's
through `params_from_jax`) and query the same codebook, in which the codes
of some crops are planted. Codebook indices must be identical; rotations
and translations agree within atol 1e-6 (translations are in mm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu import factory as jfactory
from augmentedautoencoder_tpu.codebook import Codebook as JaxCodebook
from augmentedautoencoder_tpu.codebook import tta_jittered_bboxes as jax_tta
from augmentedautoencoder_tpu.config import TrainConfig
from augmentedautoencoder_tpu.geometry import view_sampler
from augmentedautoencoder_tpu.models import AAE as JaxAAE
from augmentedautoencoder_torch import factory
from augmentedautoencoder_torch.codebook import Codebook, tta_jittered_bboxes
from augmentedautoencoder_torch.convert import params_from_jax
from augmentedautoencoder_torch.models import AAE

torch.set_num_threads(1)

ATOL = 1e-6
N_CROPS = 10


@pytest.fixture(scope="module")
def pair():
    cfg = TrainConfig()
    cfg.h = cfg.w = 32
    cfg.latent_space_size = 16
    cfg.num_filter = [8, 16]
    cfg.strides = [2, 2]
    cfg.radius = 300.0
    cfg.k = [100, 0, 16, 0, 100, 16, 0, 0, 1]
    jmodel = JaxAAE.from_config(cfg)
    x0 = jnp.zeros((1, 32, 32, 3))
    params = jmodel.init({"params": jax.random.PRNGKey(3)}, x0, method=jmodel.encode)["params"]
    model = AAE.from_config(cfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    model.eval()

    rng = np.random.RandomState(0)
    crops = rng.randint(0, 256, (N_CROPS, 32, 32, 3)).astype(np.uint8)
    views = view_sampler.viewsphere_rotations(12, 4)
    n = len(views)
    emb = rng.randn(n, 16).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    jencode = jfactory.make_encode_fn(jmodel, params)
    codes = np.asarray(jencode(crops))
    planted = rng.choice(n, N_CROPS, replace=False)
    emb[planted] = codes / np.linalg.norm(codes, axis=1, keepdims=True)
    bbs = np.concatenate([rng.randint(0, 10, (n, 2)), rng.randint(15, 30, (n, 2))], axis=1)
    jcb = JaxCodebook(jencode, views, emb, bbs, num_cyclo=4)
    cb = Codebook(factory.make_encode_fn(model), views, emb, bbs, num_cyclo=4, device="cpu")
    return cfg, crops, planted, jcb, cb


def _tta_stack(crops, n_det, tta):
    """Detection-major (n_det * tta) stack: each detection's crop, then
    tta - 1 slightly perturbed copies (as jittered crops of one object)."""
    rng = np.random.RandomState(tta)
    out = []
    for d in range(n_det):
        out.append(crops[d])
        for _ in range(tta - 1):
            noise = rng.randint(-12, 13, crops[d].shape)
            out.append(np.clip(crops[d].astype(int) + noise, 0, 255).astype(np.uint8))
    return np.stack(out)


def test_test_embedding(pair):
    _, crops, _, jcb, cb = pair
    np.testing.assert_allclose(cb.test_embedding(crops), jcb.test_embedding(crops), atol=1e-5, rtol=0)


@pytest.mark.parametrize("top_n,upright", [(1, False), (1, True), (5, False), (5, True)])
def test_nearest_rotation(pair, top_n, upright):
    _, crops, planted, jcb, cb = pair
    for i in range(4):
        want = jcb.nearest_rotation(crops[i], top_n=top_n, upright=upright, return_idcs=True)
        got = cb.nearest_rotation(crops[i], top_n=top_n, upright=upright, return_idcs=True)
        np.testing.assert_array_equal(got, want)
        if top_n == 1 and not upright:
            assert got[0] == planted[i]  # planted self-retrieval
    np.testing.assert_array_equal(cb.nearest_rotation(crops[0]), jcb.nearest_rotation(crops[0]))


def test_nearest_rotation_batch(pair):
    _, crops, planted, jcb, cb = pair
    got = cb.nearest_rotation_batch(crops)
    np.testing.assert_array_equal(got, jcb.nearest_rotation_batch(crops))
    np.testing.assert_array_equal(got, cb.viewsphere[planted])


@pytest.mark.parametrize("k,upright,tta", [(1, False, 1), (6, False, 1), (6, True, 1), (4, False, 2), (500, True, 1)])
def test_topk_candidates(pair, k, upright, tta):
    _, crops, _, jcb, cb = pair
    xs = _tta_stack(crops, N_CROPS // tta, tta)
    want_i, want_s = jcb.topk_candidates(xs, k, upright=upright, tta=tta)
    got_i, got_s = cb.topk_candidates(xs, k, upright=upright, tta=tta)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, atol=1e-5, rtol=0)


@pytest.mark.parametrize("top_n,upright,depth", [(1, False, None), (3, False, None), (1, True, 250.0)])
def test_auto_pose6d(pair, top_n, upright, depth):
    cfg, crops, _, jcb, cb = pair
    bb = [40.0, 30.0, 22.0, 25.0]
    K = np.array([[110.0, 0, 60], [0, 105.0, 50], [0, 0, 1]])
    want = jcb.auto_pose6d(crops[2], bb, K, top_n, cfg, depth_pred=depth, upright=upright)
    got = cb.auto_pose6d(crops[2], bb, K, top_n, cfg, depth_pred=depth, upright=upright)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "upright,agg,tta", [(False, 1, 1), (True, 1, 1), (False, 8, 1), (False, 1, 3), (True, 4, 2)]
)
def test_auto_pose6d_batch(pair, upright, agg, tta):
    cfg, crops, _, jcb, cb = pair
    rng = np.random.RandomState(1)
    n_det = N_CROPS // tta
    bbs = np.concatenate([rng.randint(0, 60, (n_det, 2)), rng.randint(10, 40, (n_det, 2))], axis=1).astype(float)
    K = np.array([[100.0, 0, 50], [0, 100.0, 40], [0, 0, 1]])
    xs = _tta_stack(crops, n_det, tta)
    want = jcb.auto_pose6d_batch(xs, bbs, K, cfg, upright=upright, topk_aggregate=agg, tta=tta)
    got = cb.auto_pose6d_batch(xs, bbs, K, cfg, upright=upright, topk_aggregate=agg, tta=tta)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL, rtol=0)


def test_pose6d_from_indices(pair):
    cfg, _, _, jcb, cb = pair
    rng = np.random.RandomState(4)
    bbs = rng.uniform(5, 40, (3, 4))
    K = np.array([[100.0, 0, 50], [0, 100.0, 40], [0, 0, 1]])
    for idcs, depth in [(np.array([0, 7, 12]), None), (rng.randint(0, 48, (3, 4)), np.array([200.0, 250.0, 300.0]))]:
        want = jcb.pose6d_from_indices(idcs, bbs, K, cfg, depth_pred=depth)
        got = cb.pose6d_from_indices(idcs, bbs, K, cfg, depth_pred=depth)
        np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[1], want[1], atol=ATOL, rtol=0)


def test_tta_bboxes_and_clamp(pair):
    _, _, _, jcb, cb = pair
    np.testing.assert_array_equal(tta_jittered_bboxes([10, 20, 30, 40], 16), jax_tta([10, 20, 30, 40], 16))
    with pytest.raises(ValueError):
        tta_jittered_bboxes([0, 0, 1, 1], 17)
    for k, stride in [(5, 1), (500, 1), (500, 4), (3, 4)]:
        assert cb._clamp_k(k, stride) == jcb._clamp_k(k, stride)
