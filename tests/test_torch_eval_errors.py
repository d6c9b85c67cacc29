"""The port's pose errors, matching and result writers against the JAX
package's, on the CPU, from the same seeded numpy inputs.

`add`, `re`, `te`, `proj` and `cou_mask` are the same numpy code: equal to
1e-12 relative. `vsd` renders the estimate and the GT with the port's
native rasterizer, bit-equal to the JAX one (tests/test_torch_renderer.py),
so it must equal the JAX value exactly. `adi`'s nearest neighbour is B4's
plain version here (`ops.icp_nn.batched_nn_torch`, centred on the
destination's tree mean, every op rounded on its own) where the JAX package
takes the argmin of an XLA distance matrix: indices may differ where two
points are within rounding, so the mean distance is held to 1e-5
relative. The writers' files must be byte-equal."""

import os

import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.evaluation import pose_errors as jpe
from augmentedautoencoder_torch.evaluation import pose_errors as tpe

from _torch_port_ws import EVAL_HW, EVAL_K, global_rng_guard, write_procedural_mesh  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """(model points (N, 3), the port's and the JAX package's native
    renderers) of one procedural mesh."""
    from augmentedautoencoder_tpu.renderer import Renderer as JaxRenderer
    from augmentedautoencoder_tpu.renderer.mesh import load_mesh as jax_load_mesh
    from augmentedautoencoder_torch.renderer import Renderer, load_mesh

    ply = write_procedural_mesh(tmp_path_factory.mktemp("eval_errors") / "obj.ply", subdivisions=2, radius=45.0)
    m = load_mesh(ply)
    return (m.vertices, Renderer([], backend="native", meshes=[m]),
            JaxRenderer([], backend="native", meshes=[jax_load_mesh(ply)]))


def _poses(seed):
    """A GT pose at 300-330 mm and an estimate off by up to ~10 degrees
    and ~10 mm."""
    from augmentedautoencoder_torch.geometry import transform

    rng = np.random.RandomState(seed)
    R_gt = transform.random_rotation_matrix(rng.rand(3))[:3, :3]
    t_gt = np.array([rng.uniform(-20, 20), rng.uniform(-15, 15), rng.uniform(300, 330)])
    dR = transform.rotation_matrix(np.radians(rng.uniform(1, 10)), rng.randn(3))[:3, :3]
    return dR @ R_gt, t_gt + rng.uniform(-10, 10, 3), R_gt, t_gt


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("error_type", ["add", "adi", "re", "te", "proj"])
def test_point_errors_match_jax(mesh, error_type, seed):
    pts = mesh[0]
    R_est, t_est, R_gt, t_gt = _poses(seed)
    want = jpe.calc_error(error_type, R_est, t_est, R_gt, t_gt, pts=pts, K=EVAL_K)
    got = tpe.calc_error(error_type, R_est, t_est, R_gt, t_gt, pts=pts, K=EVAL_K, device="cpu")
    assert isinstance(got, float) and got > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5 if error_type == "adi" else 1e-12)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cost", ["step", "tlinear"])
def test_vsd_matches_jax_exactly(mesh, cost, seed):
    """VSD against a depth frame with the object at its GT pose behind an
    occluding slab over the left quarter (so visibility masks matter)."""
    pts, renderer, jax_renderer = mesh
    R_est, t_est, R_gt, t_gt = _poses(seed)
    H, W = EVAL_HW
    _, depth = renderer.render(0, W, H, EVAL_K, R_gt, t_gt, 10, 10000)
    depth = depth.astype(np.float64)
    depth[:, : W // 4] = np.where(depth[:, : W // 4] > 0, 250.0, 0.0)
    kw = dict(delta=15.0, tau=20.0, cost=cost)
    got = tpe.vsd(R_est, t_est, R_gt, t_gt, depth, EVAL_K, renderer, **kw)
    want = jpe.vsd(R_est, t_est, R_gt, t_gt, depth, EVAL_K, jax_renderer, **kw)
    assert 0.0 < got <= 1.0
    assert got == want


def test_cou_mask_matches_jax():
    rng = np.random.RandomState(4)
    a, b = rng.rand(40, 50) > 0.6, rng.rand(40, 50) > 0.5
    assert tpe.cou_mask(a, b) == jpe.cou_mask(a, b)
    assert tpe.cou_mask(a & False, b & False) == jpe.cou_mask(a & False, b & False) == 0.0


def test_adi_many_is_one_lane_per_pair(mesh):
    """One B4 call with a lane per (estimate, GT) pair gives each pair's
    own value, and an estimate at its GT pose scores 0."""
    pts = mesh[0]
    pairs = [_poses(s) for s in range(4)]
    R, t = pairs[0][2], pairs[0][3]
    pairs.append((R, t, R, t))
    many = tpe.adi_many(pairs, pts, device="cpu")
    assert many == [tpe.adi(*p, pts, device="cpu") for p in pairs]
    assert many[-1] == 0.0 and tpe.adi_many([], pts, device="cpu") == []


def test_adi_runs_on_the_gpu_unless_told_otherwise(mesh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tpe.adi(*_poses(0), mesh[0])


@pytest.mark.parametrize("error_type", ["vsd", "cou", "re", "te", "add", "adi", "proj"])
def test_error_threshold_matches_jax(error_type):
    from augmentedautoencoder_tpu.evaluation.matching import error_threshold as jet
    from augmentedautoencoder_torch.evaluation.matching import error_threshold

    kw = dict(error_thresh=0.25, error_thresh_deg=7.0, error_thresh_mm=33.0, model_diameter=131.0)
    assert error_threshold(error_type, **kw) == jet(error_type, **kw)


def _estimates(module, seed):
    """Seeded EstimateErrors of 6 images, 1-3 GTs and 1-4 estimates each."""
    rng = np.random.RandomState(seed)
    out, n_gts = [], {}
    for im in range(6):
        n_gt = rng.randint(1, 4)
        n_gts[(1, im, 1)] = n_gt
        for _ in range(rng.randint(1, 5)):
            out.append(module.EstimateErrors(scene_id=1, im_id=im, obj_id=1, score=float(rng.rand()),
                                             errors={g: float(rng.rand()) for g in range(n_gt)}))
    return out, n_gts


@pytest.mark.parametrize("n_top", [1, 0])
def test_matching_and_scores_match_jax(n_top):
    from augmentedautoencoder_tpu.evaluation import matching as jm
    from augmentedautoencoder_torch.evaluation import matching as tm

    ests_t, n_gts = _estimates(tm, 5)
    ests_j, _ = _estimates(jm, 5)
    got = tm.match_and_eval_performance_scores(ests_t, n_gts, 0.4, n_top=n_top)
    want = jm.match_and_eval_performance_scores(ests_j, n_gts, 0.4, n_top=n_top)
    assert got == want and 0 < got["n_correct"] < got["n_gt"]
    m_t = tm.match_poses(ests_t[:4], 0.4, n_top)
    m_j = jm.match_poses(ests_j[:4], 0.4, n_top)
    assert [(e.score, g) for e, g in m_t] == [(e.score, g) for e, g in m_j]


def _results(module):
    """EvalResults of two scenes and three views, several estimates in one."""
    rng = np.random.RandomState(6)
    out = []
    for scene, im in ((1, 0), (1, 0), (1, 3), (2, 7)):
        R, t = np.linalg.qr(rng.randn(3, 3))[0], rng.uniform(-50, 700, 3)
        out.append(module.EvalResult(scene_id=scene, im_id=im, obj_id=3, R_est=R, t_est=t,
                                     score=float(rng.rand()), gt_idx=0, run_time=0.125))
    return out


def test_sixd_writer_files_byte_equal(tmp_path):
    from augmentedautoencoder_tpu.evaluation import evaluator as je
    from augmentedautoencoder_tpu.evaluation.sixd_writer import write_sixd_results as jax_write
    from augmentedautoencoder_torch.evaluation import evaluator as te_
    from augmentedautoencoder_torch.evaluation.sixd_writer import load_results_sixd17, write_sixd_results

    got = write_sixd_results(str(tmp_path / "port"), _results(te_))
    want = jax_write(str(tmp_path / "jax"), _results(je))
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == [
        os.path.relpath(p, tmp_path / "jax") for p in want] == ["01/0000_03.yml", "01/0003_03.yml", "02/0007_03.yml"]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    back = load_results_sixd17(got[0])
    assert back["run_time"] == 0.25 and len(back["ests"]) == 2
    np.testing.assert_allclose(back["ests"][0]["R"], _results(te_)[0].R_est, atol=1e-8)


def test_bop_csv_byte_equal(tmp_path):
    from augmentedautoencoder_tpu.evaluation import bop_writer as jb
    from augmentedautoencoder_torch.evaluation import bop_writer as tb

    def rows(module):
        rng = np.random.RandomState(7)
        return [module.BopEstimate(scene_id=s, im_id=i, obj_id=5, score=float(rng.rand()),
                                   R=np.linalg.qr(rng.randn(3, 3))[0], t=rng.uniform(-50, 700, 3), time=0.15 + i)
                for s, i in ((1, 0), (1, 1), (3, 2))]

    got = tb.write_bop_csv(rows(tb), str(tmp_path / "port"), "aae", "lm", "test")
    want = jb.write_bop_csv(rows(jb), str(tmp_path / "jax"), "aae", "lm", "test")
    assert os.path.basename(got) == os.path.basename(want) == "aae_lm-test.csv"
    assert open(got, "rb").read() == open(want, "rb").read()
    back = tb.read_bop_csv(got)
    assert [(e.scene_id, e.im_id, e.obj_id) for e in back] == [(1, 0, 5), (1, 1, 5), (3, 2, 5)]
    np.testing.assert_allclose(back[2].t, rows(tb)[2].t, atol=1e-8)
