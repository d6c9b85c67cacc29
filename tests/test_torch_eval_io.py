"""The evaluation's file side in the port against the JAX package and
OpenCV, on the CPU: the PNG reader against cv2.imread (BGR, gray, 16-bit
depth, masks, BGRA) on files written by cv2 and by the port's writer; the
scene loader on the BOP json and the legacy sixd yaml layouts; the eval
config; and the workspace's eval template."""

import dataclasses
import filecmp
import os
import sys

import cv2
import numpy as np
import pytest

from augmentedautoencoder_torch.utils.png import read_png, write_png

from _torch_port_ws import EVAL_K, eval_scene_poses, global_rng_guard, write_bop_scene, write_procedural_mesh  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kind: (image from a seeded RandomState, the writer, cv2.imread flag)
_U = cv2.IMREAD_UNCHANGED
IMAGES = {
    "bgr_port": (lambda r: r.randint(0, 256, (37, 53, 3)).astype(np.uint8), "port", cv2.IMREAD_COLOR),
    "bgr_cv2": (lambda r: r.randint(0, 256, (37, 53, 3)).astype(np.uint8), "cv2", cv2.IMREAD_COLOR),
    "bgr_port_unchanged": (lambda r: r.randint(0, 256, (20, 31, 3)).astype(np.uint8), "port", _U),
    "gray_as_color": (lambda r: r.randint(0, 256, (29, 17)).astype(np.uint8), "port", cv2.IMREAD_COLOR),
    "depth16_port": (lambda r: r.randint(0, 65536, (33, 41)).astype(np.uint16), "port", _U),
    "depth16_cv2": (lambda r: r.randint(0, 65536, (33, 41)).astype(np.uint16), "cv2", _U),
    "depth16_as_color": (lambda r: r.randint(0, 65536, (9, 12)).astype(np.uint16), "cv2", cv2.IMREAD_COLOR),
    "mask_port": (lambda r: (r.rand(24, 30) > 0.5).astype(np.uint8) * 255, "port", _U),
    "mask_cv2": (lambda r: (r.rand(24, 30) > 0.5).astype(np.uint8) * 255, "cv2", _U),
    "bgra_cv2": (lambda r: r.randint(0, 256, (14, 19, 4)).astype(np.uint8), "cv2", _U),
}


@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_read_png_equals_cv2_imread(tmp_path, kind):
    make, writer, flag = IMAGES[kind]
    img = make(np.random.RandomState(len(kind)))
    path = str(tmp_path / f"{kind}.png")
    if writer == "port":
        write_png(path, img)
    else:
        assert cv2.imwrite(path, img)
    want = cv2.imread(path, flag)
    got = read_png(path, unchanged=flag == _U)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if writer == "port":  # the writer keeps every pixel
        np.testing.assert_array_equal(cv2.imread(path, _U), img)


def test_read_png_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_png(str(tmp_path / "none.png"))


@pytest.fixture(scope="module")
def scene_ply(tmp_path_factory):
    return write_procedural_mesh(tmp_path_factory.mktemp("eval_io") / "obj.ply", subdivisions=2, radius=45.0)


def _loaders_agree(scene_dir):
    from augmentedautoencoder_tpu.evaluation.scene_loader import SceneLoader as JaxLoader
    from augmentedautoencoder_torch.evaluation.scene_loader import SceneLoader

    got, want = SceneLoader(scene_dir), JaxLoader(scene_dir)
    assert got.im_ids == want.im_ids
    for im_id in want.im_ids:
        assert len(got.gt[im_id]) == len(want.gt[im_id])
        for g, w in zip(got.gt[im_id], want.gt[im_id]):
            assert (g.obj_id, g.bbox_obj, g.bbox_visib, g.visib_fract) == (
                w.obj_id, w.bbox_obj, w.bbox_visib, w.visib_fract)
            np.testing.assert_array_equal(g.R, w.R)
            np.testing.assert_array_equal(g.t, w.t)
        np.testing.assert_array_equal(got.cameras[im_id]["K"], want.cameras[im_id]["K"])
        assert got.cameras[im_id]["depth_scale"] == want.cameras[im_id]["depth_scale"]
        for load in ("load_rgb", "load_depth"):
            a, b = getattr(got, load)(im_id), getattr(want, load)(im_id)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for gi in range(len(want.gt[im_id]) + 1):  # the last one has no file: None
            a, b = got.load_mask_visib(im_id, gi), want.load_mask_visib(im_id, gi)
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("writer", ["port", "cv2"])
def test_bop_scene_loader_matches_jax(tmp_path, scene_ply, writer):
    poses, _ = eval_scene_poses(n_images=2, instances=2, seed=1)
    scene_dir = write_bop_scene(tmp_path / "data", scene_ply, poses, writer=writer)
    loader = _loaders_agree(scene_dir)
    assert loader.load_depth(0).max() > 290.0  # millimetres of the rendered objects
    from augmentedautoencoder_tpu.evaluation.scene_loader import scene_dir_for as jax_dir_for
    from augmentedautoencoder_torch.evaluation.scene_loader import scene_dir_for

    assert scene_dir_for(str(tmp_path / "data"), 1) == jax_dir_for(str(tmp_path / "data"), 1) == scene_dir


def _write_sixd_scene(root, ply):
    """The legacy layout: test_primesense/01/{rgb,depth}/<im:04d>.png,
    gt.yml and info.yml (depth_scale 0.5 on image 1)."""
    import yaml

    from augmentedautoencoder_torch.renderer import Renderer, load_mesh

    poses, _ = eval_scene_poses(n_images=2, instances=1, seed=2)
    renderer = Renderer([], backend="native", meshes=[load_mesh(ply)])
    scene_dir = os.path.join(str(root), "test_primesense", "01")
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
    gt, info = {}, {}
    for i, [(R, t)] in enumerate(poses):
        bgr, depth = renderer.render(0, 128, 96, EVAL_K, R, t, 10, 10000)
        write_png(os.path.join(scene_dir, "rgb", f"{i:04d}.png"), bgr)
        write_png(os.path.join(scene_dir, "depth", f"{i:04d}.png"), np.round(depth / (1 + i)).astype(np.uint16))
        gt[i] = [{"obj_id": 1, "cam_R_m2c": R.ravel().tolist(), "cam_t_m2c": t.tolist(), "obj_bb": [40, 30, 50, 40]}]
        info[i] = {"cam_K": EVAL_K.ravel().tolist(), "depth_scale": 1.0 / (1 + i)}
    for name, data in (("gt.yml", gt), ("info.yml", info)):
        with open(os.path.join(scene_dir, name), "w") as fh:
            yaml.safe_dump(data, fh)
    return scene_dir


def test_sixd_scene_loader_matches_jax(tmp_path, scene_ply):
    scene_dir = _write_sixd_scene(tmp_path, scene_ply)
    loader = _loaders_agree(scene_dir)
    assert loader.gt[0][0].bbox_obj == [40, 30, 50, 40]
    from augmentedautoencoder_torch.evaluation.scene_loader import scene_dir_for

    assert scene_dir_for(str(tmp_path), 1, "primesense") == scene_dir


def test_sixd_layout_without_yaml_names_the_layout(tmp_path, scene_ply, monkeypatch):
    from augmentedautoencoder_torch.evaluation.scene_loader import SceneLoader

    scene_dir = _write_sixd_scene(tmp_path, scene_ply)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="sixd scene layout"):
        SceneLoader(scene_dir)


EVAL_TEXTS = {
    "template": None,
    "custom": """
[DATA]
DATASET: lm
DATASET_PATH: /data/lm
OBJ_ID: 5
SCENES: [1, 2, 3]
OBJ_IDS: [5]
CAM_TYPE: kinect
[BBOXES]
ESTIMATE_BBS: True
DETECTIONS_PATH: /data/dets.json
SINGLE_INSTANCE: False
ICP: True
GT_MASKS: True
TOPK_RESCORE: 4
TTA_CROPS: 3
ICP_FRAME_ACCURATE: True
[METRIC]
ERROR_TYPES: ['add', 'adi', 'proj']
VSD_COST: tlinear
ERROR_THRESH_MM: 2*25
[PLOT]
COMPUTE_PLOTS: False
ANIMATE_EMBEDDING_PCA: True
""",
}


@pytest.mark.parametrize("name", sorted(EVAL_TEXTS))
def test_eval_config_matches_jax(tmp_path, name):
    from augmentedautoencoder_tpu.config.eval_config import load_eval_config as jax_load
    from augmentedautoencoder_torch.config import load_eval_config

    path = os.path.join(REPO, "augmentedautoencoder_torch", "cfg_templates", "eval_template.cfg")
    if EVAL_TEXTS[name] is not None:
        path = str(tmp_path / "eval.cfg")
        with open(path, "w") as fh:
            fh.write(EVAL_TEXTS[name])
    assert dataclasses.asdict(load_eval_config(path)) == dataclasses.asdict(jax_load(path))


def test_eval_config_refuses_rescore_with_aggregate(tmp_path):
    from augmentedautoencoder_torch.config import load_eval_config

    path = str(tmp_path / "eval.cfg")
    with open(path, "w") as fh:
        fh.write("[BBOXES]\nTOPK_RESCORE: 2\nTOPK_AGGREGATE: 4\n")
    with pytest.raises(ValueError, match="mutually exclusive"):
        load_eval_config(path)


def test_init_workspace_writes_both_templates(tmp_path, monkeypatch, capsys):
    """The port's workspace gets cfg_eval/eval_template.cfg (its template
    directory once held only the train template, and init_workspace skipped
    the missing file in silence), equal to the JAX package's, through the
    library and through the ae_init_workspace CLI."""
    from augmentedautoencoder_torch import workspace as ws
    from augmentedautoencoder_torch.cli import ae_init_workspace

    jax_templates = os.path.join(REPO, "augmentedautoencoder_tpu", "cfg_templates")
    ws.init_workspace(str(tmp_path / "lib"))
    monkeypatch.setenv("AE_WORKSPACE_PATH", str(tmp_path / "cli"))
    ae_init_workspace.main()
    assert "Initialized workspace" in capsys.readouterr().out
    for root in ("lib", "cli"):
        for sub, name in (("cfg_eval", "eval_template.cfg"), ("cfg", "train_template.cfg")):
            path = tmp_path / root / sub / name
            assert path.exists(), path
            if name == "eval_template.cfg":
                assert filecmp.cmp(path, os.path.join(jax_templates, name), shallow=False)
        for sub in ("experiments", "tmp_datasets"):
            assert (tmp_path / root / sub).is_dir()
