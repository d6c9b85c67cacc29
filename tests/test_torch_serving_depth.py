"""Depth-refined serving of the port against the JAX package, on the CPU.

The workspace is _torch_port_ws.py's (Flax params from fixed keys, seeded
codebooks, converted by scripts/convert_jax_checkpoint.py) with MODEL_PATH
naming a procedural textured mesh. One frame holds 4 detections on a 2x2
grid; its depth renders every detection's mesh at the pose the recipe's RGB
path (top-1, or the top-8 blend) returns for it, 20-30 mm deeper and up to
4 mm off laterally (the error geometry of tests/test_icp_frame_accurate.py),
so ICP has a well-posed job.
Both packages then serve the frame with depth from the same seeded global
numpy stream, which ICP's subsampling draws from. The JAX loop runs
`batched_nn_pallas` in interpret mode, whose scores are the port's formula
(its CPU default, the XLA distance matrix, rounds near-ties differently and
can end a rotation-only lane elsewhere in its limit cycle). Both ICPs draw
N_SUB = 2000 points instead of 3000 to keep the CPU loop short. A lane that
runs to the 100-iteration cap in such a cycle stops at a point that
depends on f32 rounding, in either package; in this scene the lanes that
reach the cap stay within the tolerance below.

The submit-time codebook indices must be equal; poses agree to t 0.1 mm
and R 1e-3.
"""

import functools
import os

import numpy as np
import pytest
import torch

from _torch_port_ws import make_jax_workspace, write_procedural_mesh, write_test_cfg

torch.set_num_threads(1)

EXPERIMENTS = {"obj_a": 1, "obj_b": 2}
CLASSES = {"cls_a": "obj_a", "cls_b": "obj_b"}
RECIPES = {  # name: (test config lines, the RGB recipe whose poses the depth is rendered at)
    "agg8_frame_icp": ("topk_aggregate = 8\nuse_icp = True\nicp_frame_accurate = True\n", "agg8"),
    "rescore4_icp": ("topk_rescore = 4\nuse_icp = True\n", "top1"),
    "top1_icp": ("use_icp = True\n", "top1"),
}
RGB = {"top1": "", "agg8": "topk_aggregate = 8\n"}
N_SUB = 2000
T_ATOL_M = 1e-4  # 0.1 mm, poses in meters
R_ATOL = 1e-3


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_depth_ws")
    old = os.environ.get("AE_WORKSPACE_PATH")
    ply = write_procedural_mesh(root / "obj.ply", subdivisions=2, radius=45.0)
    make_jax_workspace(root / "workspace", EXPERIMENTS, model_path=ply)
    yield root, ply
    if old is None:
        os.environ.pop("AE_WORKSPACE_PATH", None)
    else:
        os.environ["AE_WORKSPACE_PATH"] = old


@pytest.fixture(autouse=True)
def _workspace_env(ws, monkeypatch):
    from augmentedautoencoder_tpu.ops.icp_nn import batched_nn_pallas
    from augmentedautoencoder_tpu.pose import icp as jicp
    from augmentedautoencoder_torch.pose import icp as ticp

    monkeypatch.setenv("AE_WORKSPACE_PATH", str(ws[0] / "workspace"))
    monkeypatch.setenv("AAE_ICP_NN", "pallas")
    monkeypatch.setattr(jicp, "batched_nn_pallas", functools.partial(batched_nn_pallas, interpret=True))
    monkeypatch.setattr(jicp, "N_SUB", N_SUB)
    monkeypatch.setattr(ticp, "N_SUB", N_SUB)
    jicp.icp_jax_batch.clear_cache()
    yield
    jicp.icp_jax_batch.clear_cache()  # later callers trace the real kernel again


@pytest.fixture(scope="module")
def frames(ws):
    """Per RGB recipe: a 240x320 frame with 2 detections per class on a 2x2
    grid and its rendered depth (mm), the depth's true translations, and
    the RGB path's translations."""
    return {name: _frame(ws, extra) for name, extra in RGB.items()}


def _frame(ws, rgb_extra):
    from augmentedautoencoder_torch.pose import BoundingBox
    from augmentedautoencoder_torch.renderer import Renderer, load_mesh
    from augmentedautoencoder_torch.serving import PoseServer

    root, ply = ws
    os.environ["AE_WORKSPACE_PATH"] = str(root / "workspace")
    H, W, side = 240, 320, 60
    rng = np.random.RandomState(21)
    boxes = []
    for k in range(4):
        cx, cy = W * (k % 2 + 0.5) / 2, H * (k // 2 + 0.5) / 2
        boxes.append(BoundingBox(xmin=(cx - side / 2) / W, ymin=(cy - side / 2) / H,
                                 xmax=(cx + side / 2) / W, ymax=(cy + side / 2) / H,
                                 classes={list(CLASSES)[k % 2]: 0.9}))
    fr = {"bboxes": boxes, "color_img": rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
          "camK": np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]])}
    rgb = PoseServer(write_test_cfg(root / "rgb.cfg", CLASSES, rgb_extra), device="cpu")
    poses = rgb.process(**fr, mm=True)
    renderer = Renderer([], backend="native", meshes=[load_mesh(ply)])
    depth = np.zeros((H, W), np.float32)
    truth = []
    for p in poses:
        t = p.trafo[:3, 3] + np.r_[rng.uniform(-4, 4, 2), rng.uniform(20, 30)]
        _, d = renderer.render(0, W, H, fr["camK"], p.trafo[:3, :3], t, 10, 10000)
        assert (d > 0).sum() > 1000
        closer = (d > 0) & ((depth == 0) | (d < depth))
        depth[closer] = d[closer]
        truth.append(t)
    return dict(fr, depth_img=depth), np.array(truth), np.array([p.trafo[:3, 3] for p in poses])


def _assert_close(got, want):
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.trafo[:3, 3], w.trafo[:3, 3], atol=T_ATOL_M, rtol=0)
        np.testing.assert_allclose(g.trafo[:3, :3], w.trafo[:3, :3], atol=R_ATOL, rtol=0)


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_pose_server_with_depth_matches_jax(ws, frames, recipe):
    from augmentedautoencoder_tpu.serving import PoseServer as JaxServer
    from augmentedautoencoder_torch.serving import PoseServer

    extra, rgb = RECIPES[recipe]
    frame = frames[rgb][0]
    cfg_path = write_test_cfg(ws[0] / f"srv_{recipe}.cfg", CLASSES, extra)
    server = PoseServer(cfg_path, max_dets_per_class=4, device="cpu", profile=True)
    jserver = JaxServer(cfg_path, max_dets_per_class=4)
    h, jh = server.submit(**frame), jserver.submit(**frame)
    for cls in h.idcs:
        np.testing.assert_array_equal(
            torch.cat(h.idcs[cls]).numpy(), np.concatenate([np.asarray(a) for a in jh.idcs[cls]])
        )
    np.random.seed(11)
    got = server.retrieve(h)
    np.random.seed(11)
    want = jserver.retrieve(jh)
    _assert_close(got, want)
    assert "icp" in server.profile_summary()
    # ICP moved the poses: the RGB path alone differs from the refined one
    rgb = server.process(**{k: v for k, v in frame.items() if k != "depth_img"})
    assert max(abs(a.trafo[2, 3] - b.trafo[2, 3]) for a, b in zip(got, rgb)) > 5e-3


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_estimator_with_depth_matches_jax(ws, frames, recipe):
    from augmentedautoencoder_tpu.pose import AePoseEstimator as JaxEstimator
    from augmentedautoencoder_torch.pose import AePoseEstimator

    extra, rgb = RECIPES[recipe]
    frame = frames[rgb][0]
    cfg_path = write_test_cfg(ws[0] / f"est_{recipe}.cfg", CLASSES, extra)
    est, jest = AePoseEstimator(cfg_path, device="cpu"), JaxEstimator(cfg_path)
    np.random.seed(11)
    got = est.process(**frame)
    np.random.seed(11)
    want = jest.process(**frame)
    _assert_close(got, want)


def test_icp_lowers_the_translation_error(ws, frames):
    """Frame-accurate ICP brings every detection's translation closer to the
    one its depth was rendered at (20-30 mm away before)."""
    from augmentedautoencoder_torch.serving import PoseServer

    frame, truth, before = frames["top1"]
    cfg = write_test_cfg(ws[0] / "gain.cfg", CLASSES, "use_icp = True\nicp_frame_accurate = True\n")
    np.random.seed(5)
    after = np.array([p.trafo[:3, 3] for p in PoseServer(cfg, device="cpu").process(**frame, mm=True)])
    err_before = np.linalg.norm(before - truth, axis=1)
    err_after = np.linalg.norm(after - truth, axis=1)
    assert np.all(err_after < err_before), (err_before, err_after)
    assert np.median(err_after) < 6.0, err_after
