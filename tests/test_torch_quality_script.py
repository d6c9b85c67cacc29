"""scripts/quality_eval_vsd_torch.py, the port's quality arm, against the
JAX package's scripts/quality_eval_vsd.py on the CPU at a tiny size: the
same scenes from the same seed (GT poses, camera, visibility info equal;
masks, depth and colour images bit for bit), the same configs, and its
bounds of agreement."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return _load("quality_eval_vsd_torch"), _load("quality_eval_vsd")


@pytest.fixture(scope="module")
def scenes(scripts, tmp_path_factory):
    """Two images of 2 instances from each script, after different global
    np.random states (make_scenes seeds its own)."""
    from augmentedautoencoder_torch.renderer.procedural import make_textured_asymmetric, save_ply

    port, jax_script = scripts
    root = tmp_path_factory.mktemp("quality_scenes")
    model_path = str(root / "obj.ply")
    save_ply(make_textured_asymmetric(subdivisions=1, radius=60.0), model_path)
    state = np.random.get_state()
    try:
        np.random.seed(1)
        port.make_scenes(str(root / "port"), model_path, n=2, seed=123, instances=2)
        np.random.seed(2)
        jax_script.make_scenes(str(root / "jax"), model_path, n=2, seed=123, instances=2)
    finally:
        np.random.set_state(state)
    return root / "port" / "test" / "000001", root / "jax" / "test" / "000001"


def _read_png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def test_scene_files_are_the_same_set(scenes):
    port, jax_dir = scenes
    names = sorted(str(p.relative_to(port)) for p in port.rglob("*") if p.is_file())
    assert names == sorted(str(p.relative_to(jax_dir)) for p in jax_dir.rglob("*") if p.is_file())
    assert len([n for n in names if n.startswith("mask_visib")]) == 4


@pytest.mark.parametrize("name", ["scene_gt", "scene_camera", "scene_gt_info"])
def test_scene_json_equals_jax(scenes, name):
    port, jax_dir = scenes
    got, want = (json.loads((d / f"{name}.json").read_text()) for d in (port, jax_dir))
    assert got == want


@pytest.mark.parametrize("sub", ["depth", "mask_visib"])
def test_masks_and_depth_bit_equal_to_jax(scenes, sub):
    port, jax_dir = scenes
    for path in sorted((port / sub).glob("*.png")):
        got, want = _read_png(path), _read_png(jax_dir / sub / path.name)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=path.name)
        assert got.any()


def test_rgb_bit_equal_to_jax(scenes):
    port, jax_dir = scenes
    for path in sorted((port / "rgb").glob("*.png")):
        got, want = _read_png(path), _read_png(jax_dir / "rgb" / path.name)
        assert got.shape == want.shape == (270, 360, 3)
        np.testing.assert_array_equal(got, want, err_msg=path.name)


def test_configs_and_recipe_match_jax(scripts):
    port, jax_script = scripts
    # PRECISION is a slot in both, filled from --precision
    assert port.TRAIN_CFG == jax_script.TRAIN_CFG
    # COMPUTE_PLOTS follows whether matplotlib imports, where the JAX script says True
    assert port.EVAL_CFG == jax_script.EVAL_CFG.replace("COMPUTE_PLOTS: True", "COMPUTE_PLOTS: {compute_plots}")
    assert (port.W, port.H, port.RADIUS) == (jax_script.W, jax_script.H, jax_script.RADIUS)
    np.testing.assert_array_equal(port.K, jax_script.K)


def test_bounds_are_two_standard_errors_below_the_jax_recalls(scripts):
    port, _ = scripts
    for key in ("vsd_recall@0.3", "re_recall@15deg", "add_recall@0.1d"):
        p = port.TARGET[key]
        op, bound = port.BOUNDS[key]
        assert op == ">=" and bound == pytest.approx(p - 2 * np.sqrt(2 * p * (1 - p) / 150), abs=5e-3)
    summary = dict(port.TARGET)
    assert all(port.within_bounds(summary).values())
    summary["median_te_mm"] = 5.6
    assert not port.within_bounds(summary)["median_te_mm"]


def test_bf16_bounds_are_two_standard_errors_below_the_port_f32_arm(scripts):
    """The bf16 arm's bounds: each recall two standard errors below the
    port's own f32 arm (its committed result, to 4 places), te and the
    medians as the f32 arm's bounds."""
    port, _ = scripts
    with open(REPO / "scripts" / "quality_vsd_torch_asym_clutter_inst3_icp_frame_agg8.json") as fh:
        f32 = json.load(fh)
    assert f32["precision"] == "float32" and f32["seed"] == port.SEED
    for key, value in port.PORT_F32.items():
        assert value == pytest.approx(f32[key], abs=5e-5), key
    for key in ("vsd_recall@0.3", "re_recall@15deg", "add_recall@0.1d"):
        p = port.PORT_F32[key]
        op, bound = port.BF16_BOUNDS[key]
        assert op == ">=" and bound == pytest.approx(p - 2 * np.sqrt(2 * p * (1 - p) / 150), abs=1e-3)
        assert bound >= port.BOUNDS[key][1]  # at least as strict as the f32 arm's bound against JAX
    for key in ("te_recall@100mm", "median_re_deg", "median_te_mm"):
        assert port.BF16_BOUNDS[key] == port.BOUNDS[key]
    assert all(port.within_bounds(dict(port.PORT_F32), port.BF16_BOUNDS).values())


def test_backgrounds_are_seeded_420_jpegs(scripts, tmp_path):
    from PIL import Image

    port, _ = scripts
    port.write_backgrounds(str(tmp_path), n=3, seed=0)
    again = tmp_path / "again"
    port.write_backgrounds(str(again), n=3, seed=0)
    names = sorted(p.name for p in tmp_path.glob("*.jpg"))
    assert names == ["bg_000.jpg", "bg_001.jpg", "bg_002.jpg"]
    for name in names:
        assert (tmp_path / name).read_bytes() == (again / name).read_bytes()
        with Image.open(tmp_path / name) as im:
            assert im.size == (128, 128) and [layer[1:3] for layer in im.layer] == [(2, 2), (1, 1), (1, 1)]
