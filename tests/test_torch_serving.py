"""The port's serving slice end to end against the JAX package, pose for pose.

The workspace is built without rendering or training (_torch_port_ws.py):
Flax params from a fixed key, a seeded codebook in a JAX checkpoint, and
the port's checkpoint written by scripts/convert_jax_checkpoint.py. Both packages then
serve the same frames on the CPU. Codebook indices must agree exactly, so
the trafos agree to f32 rounding: atol 1e-5.
"""

import os

import numpy as np
import pytest
import torch

from _torch_port_ws import make_frames, make_jax_workspace, write_test_cfg

torch.set_num_threads(1)

ATOL = 1e-5
EXPERIMENTS = {"obj_a": 1, "obj_b": 2}
CLASSES = {"cls_a": "obj_a", "cls_b": "obj_b"}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_port_ws")
    old = os.environ.get("AE_WORKSPACE_PATH")
    make_jax_workspace(root / "workspace", EXPERIMENTS)
    yield root
    if old is None:
        os.environ.pop("AE_WORKSPACE_PATH", None)
    else:
        os.environ["AE_WORKSPACE_PATH"] = old


@pytest.fixture(autouse=True)
def _workspace_env(ws, monkeypatch):
    monkeypatch.setenv("AE_WORKSPACE_PATH", str(ws / "workspace"))


def _servers(cfg_path, max_dets):
    from augmentedautoencoder_tpu.serving import PoseServer as JaxServer
    from augmentedautoencoder_torch.serving import PoseServer

    return JaxServer(cfg_path, max_dets_per_class=max_dets), PoseServer(
        cfg_path, max_dets_per_class=max_dets, device="cpu"
    )


def _assert_same_poses(got, want):
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.trafo, w.trafo, atol=ATOL, rtol=0)


def test_converted_checkpoint_matches_jax_payload(ws):
    from augmentedautoencoder_tpu import factory as jfactory
    from augmentedautoencoder_torch import factory

    for name in EXPERIMENTS:
        _, _, _, jpayload = jfactory.restore_experiment(name)
        _, paths, _, payload = factory.restore_experiment(name, device="cpu")
        assert os.path.exists(os.path.join(paths["checkpoint_dir"], "chkpt-10.pt"))
        assert payload["step"] == 10
        np.testing.assert_array_equal(
            payload["embedding_normalized"].numpy(), jpayload["embedding_normalized"]
        )
        np.testing.assert_array_equal(payload["embed_obj_bbs"].numpy(), jpayload["embed_obj_bbs"])
        np.testing.assert_array_equal(
            payload["params"]["encoder.latent.weight"].numpy().T,
            jpayload["params"]["encoder"]["latent"]["kernel"],
        )


@pytest.mark.parametrize(
    "extra,max_dets",
    [("", 4), ("upright = True\n", 4), ("topk_aggregate = 8\n", 4), ("", 2)],
    ids=["top1", "upright", "agg8", "chunked"],
)
def test_pose_server_matches_jax(ws, extra, max_dets):
    cfg_path = write_test_cfg(ws / f"srv_{max_dets}_{len(extra)}.cfg", CLASSES, extra)
    jserver, server = _servers(cfg_path, max_dets)
    frames = make_frames(list(CLASSES), n_frames=3, dets_per_class=5, seed=len(extra) + max_dets)
    for fr in frames:
        _assert_same_poses(server.process(**fr), jserver.process(**fr))


def test_pose_server_stream_keeps_submit_order(ws):
    cfg_path = write_test_cfg(ws / "stream.cfg", CLASSES, "topk_aggregate = 8\n")
    _, server = _servers(cfg_path, 4)
    frames = make_frames(list(CLASSES), n_frames=5, dets_per_class=3, seed=11)
    streamed = list(server.process_stream(iter(frames), depth=2))
    assert len(streamed) == len(frames)
    for fr, got in zip(frames, streamed):
        _assert_same_poses(got, server.process(**fr))


def test_pose_server_profile_stages(ws):
    from augmentedautoencoder_torch.serving import PoseServer

    cfg_path = write_test_cfg(ws / "prof.cfg", CLASSES)
    frames = make_frames(list(CLASSES), n_frames=2, dets_per_class=2, seed=3)
    plain = PoseServer(cfg_path, max_dets_per_class=2, device="cpu")
    prof = PoseServer(cfg_path, max_dets_per_class=2, device="cpu", profile=True)
    for fr in frames:
        _assert_same_poses(prof.process(**fr), plain.process(**fr))
    assert plain.profile_times == {}
    summary = prof.profile_summary()
    assert set(summary) == {"crop_extract", "dispatch", "readback", "pose_math"}
    assert all(v >= 0.0 for v in summary.values())
    assert prof.profile_frames == 2


@pytest.mark.parametrize(
    "extra",
    ["", "upright = True\n", "topk_aggregate = 8\n", "tta_crops = 3\n"],
    ids=["top1", "upright", "agg8", "tta3"],
)
def test_estimator_matches_jax(ws, extra):
    from augmentedautoencoder_tpu.pose import AePoseEstimator as JaxEstimator
    from augmentedautoencoder_torch.pose import AePoseEstimator

    cfg_path = write_test_cfg(ws / f"est_{len(extra)}.cfg", CLASSES, extra)
    jest, est = JaxEstimator(cfg_path), AePoseEstimator(cfg_path, device="cpu")
    for fr in make_frames(list(CLASSES), n_frames=2, dets_per_class=3, seed=5 + len(extra)):
        _assert_same_poses(est.process(**fr), jest.process(**fr))


def test_server_matches_estimator_and_skips_unknown_classes(ws):
    from augmentedautoencoder_torch.pose import AePoseEstimator, BoundingBox
    from augmentedautoencoder_torch.serving import PoseServer

    cfg_path = write_test_cfg(ws / "mixed.cfg", CLASSES)
    server = PoseServer(cfg_path, max_dets_per_class=4, device="cpu")
    est = AePoseEstimator(cfg_path, device="cpu")
    fr = make_frames(list(CLASSES), n_frames=1, dets_per_class=3, seed=9)[0]
    fr["bboxes"] = list(fr["bboxes"]) + [BoundingBox(classes={"unknown": 1.0})]
    out = server.process(**fr)
    assert len(out) == 6
    _assert_same_poses(out, est.process(**fr))


@pytest.mark.parametrize("extra", ["use_icp = True\n", "topk_rescore = 4\n"], ids=["icp", "rescore"])
def test_depth_stages_are_refused(ws, extra):
    """The depth stages render each class's MODEL_PATH mesh; this workspace
    names none that exists, so a frame with depth is refused with the
    missing file (the depth stages themselves: test_torch_serving_depth.py)."""
    from augmentedautoencoder_torch.pose import AePoseEstimator
    from augmentedautoencoder_torch.serving import PoseServer

    cfg_path = write_test_cfg(ws / f"depth_{len(extra)}.cfg", CLASSES, extra)
    fr = make_frames(list(CLASSES), n_frames=1, dets_per_class=1, seed=1)[0]
    depth = np.ones(fr["color_img"].shape[:2], np.float32)
    server = PoseServer(cfg_path, max_dets_per_class=2, device="cpu")
    est = AePoseEstimator(cfg_path, device="cpu")
    assert "depth_img" in est.query_process_requirements()
    with pytest.raises(FileNotFoundError, match="/nonexistent/model.ply"):
        server.process(**fr, depth_img=depth)
    with pytest.raises(FileNotFoundError, match="/nonexistent/model.ply"):
        est.process(**fr, depth_img=depth)
    # without depth both serve, as the JAX package does
    assert len(server.process(**fr)) == len(est.process(**fr)) == 2
