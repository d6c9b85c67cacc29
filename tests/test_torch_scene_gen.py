"""The port's detector-data generators against the JAX package's:
`renderer/scenerenderer.SceneRenderer`, `renderer/write_xml` and the CLIs
`generate_syn_det_train` and `generate_sixd_train`. The same seed gives the
same images (decoded pixels) and the same XML bytes; the JAX side decodes
and writes with cv2, the port with PIL and `utils/png`."""

import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from _torch_port_ws import global_rng_guard, write_bop_scene, write_procedural_mesh  # noqa: E402,F401

K = np.array([[120.0, 0, 80], [0, 118.0, 60], [0, 0, 1]])


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_scene_gen")
    plys = [write_procedural_mesh(root / "a.ply", radius=40.0), write_procedural_mesh(root / "b.ply", radius=25.0)]
    bg_dir = root / "bg"
    bg_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        cv2.imwrite(str(bg_dir / f"bg_{i}.png"), rng.randint(0, 256, (50 + 10 * i, 70, 3)).astype(np.uint8))
    return {"root": root, "plys": plys, "bg": str(bg_dir)}


def _renderers(plys):
    from augmentedautoencoder_tpu.renderer import Renderer as JaxRenderer
    from augmentedautoencoder_tpu.renderer.mesh import load_mesh as jax_load_mesh
    from augmentedautoencoder_torch.renderer import Renderer, load_mesh

    return (JaxRenderer([], backend="native", meshes=[jax_load_mesh(p) for p in plys]),
            Renderer([], backend="native", meshes=[load_mesh(p) for p in plys]))


@pytest.mark.parametrize("objects", [(1, 1), (2, 4)], ids=["one", "two_to_four"])
@pytest.mark.parametrize("background", [True, False], ids=["bg", "black"])
def test_scene_renderer_equals_the_jax_scenes(assets, objects, background):
    from augmentedautoencoder_tpu.renderer.scenerenderer import SceneRenderer as JaxSceneRenderer
    from augmentedautoencoder_torch.renderer.scenerenderer import SceneRenderer

    jax_r, port_r = _renderers(assets["plys"])
    bg = assets["bg"] if background else str(assets["root"] / "none")
    kw = dict(vertex_tmp_store_folder=str(assets["root"]), vertex_scale=1.0, width=160, height=120, K=K,
              augmenters=None, vocdevkit_path=bg, min_num_objects_per_scene=objects[0],
              max_num_objects_per_scene=objects[1], min_n_views=50, radius=400.0, obj_ids=[7, 9])
    jax_sr = JaxSceneRenderer(assets["plys"], renderer=jax_r, **kw)
    sr = SceneRenderer(assets["plys"], renderer=port_r, **kw)
    np.testing.assert_array_equal(sr.all_view_Rs, jax_sr.all_view_Rs)
    for seed in range(3):
        np.random.seed(seed)
        want_img, want_info = jax_sr.render()
        np.random.seed(seed)
        got_img, got_info = sr.render()
        assert got_info == want_info
        np.testing.assert_array_equal(got_img, want_img)
        for o in got_info:
            x0, y0, x1, y1 = o["bb"]
            assert 0 <= x0 <= x1 < 160 and 0 <= y0 <= y1 < 120


def test_write_voc_xml_writes_the_jax_bytes(tmp_path):
    from augmentedautoencoder_tpu.renderer import write_xml as jax_write_xml
    from augmentedautoencoder_torch.renderer import write_xml

    objects = [{"id": 3, "bb": [1, 2, 30, 40]}, {"id": "duck", "bb": [5.7, 6, 7, 8]}]
    jax_write_xml.write_voc_xml(str(tmp_path / "j.xml"), "a.png", 720, 540, objects)
    write_xml.write_voc_xml(str(tmp_path / "p.xml"), "a.png", 720, 540, objects)
    assert (tmp_path / "p.xml").read_bytes() == (tmp_path / "j.xml").read_bytes()
    assert write_xml.parse_voc_xml(str(tmp_path / "p.xml")) == jax_write_xml.parse_voc_xml(str(tmp_path / "j.xml"))


def _same_outputs(port_dir, jax_dir, n_expected):
    names = sorted(os.listdir(os.path.join(jax_dir, "images")))
    assert names == sorted(os.listdir(os.path.join(port_dir, "images"))) and len(names) == n_expected
    for name in names:
        want = cv2.imread(os.path.join(jax_dir, "images", name), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(os.path.join(port_dir, "images", name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, want)
        xml = name[:-4] + ".xml"
        with open(os.path.join(jax_dir, "annotations", xml), "rb") as a, \
                open(os.path.join(port_dir, "annotations", xml), "rb") as b:
            assert b.read() == a.read()


def test_generate_syn_det_train_equals_the_jax_cli(assets, tmp_path, monkeypatch):
    from augmentedautoencoder_tpu.cli import generate_syn_det_train as jax_cli
    from augmentedautoencoder_torch.cli import generate_syn_det_train

    args = ["--model_paths", *assets["plys"], "--obj_ids", "1", "2", "--vocdevkit_path", assets["bg"],
            "--num_scenes", "3", "--width", "160", "--height", "120",
            "--K", "[120, 0, 80, 0, 118, 60, 0, 0, 1]", "--min_objects", "2", "--max_objects", "4",
            "--radius", "400"]
    np.random.seed(11)
    monkeypatch.setattr(sys, "argv", ["generate_syn_det_train", "--output_path", str(tmp_path / "jax")] + args)
    jax_cli.main()
    np.random.seed(11)
    out = generate_syn_det_train.main(["--output_path", str(tmp_path / "port")] + args)
    assert len(out["scenes"]) == 3 and all(2 <= len(s) <= 3 for s in out["scenes"])
    _same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"), 3)


def test_generate_sixd_train_equals_the_jax_cli(assets, tmp_path, monkeypatch):
    from augmentedautoencoder_tpu.cli import generate_sixd_train as jax_cli
    from augmentedautoencoder_torch.cli import generate_sixd_train

    rng = np.random.RandomState(4)
    poses = []
    for _ in range(3):
        insts = []
        for _ in range(2):
            from augmentedautoencoder_torch.geometry import transform

            R = transform.random_rotation_matrix(rng.rand(3))[:3, :3]
            insts.append((R, np.array([rng.uniform(-30, 30), rng.uniform(-20, 20), rng.uniform(280, 340)])))
        poses.append(insts)
    data = tmp_path / "data"
    write_bop_scene(data, assets["plys"][0], poses)
    args = ["--dataset_path", str(data), "--scenes", "1", "--vocdevkit_path", assets["bg"],
            "--num_images", "4", "--width", "160", "--height", "120", "--min_objects", "2",
            "--max_objects", "5", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["generate_sixd_train", "--output_path", str(tmp_path / "jax")] + args)
    jax_cli.main()
    out = generate_sixd_train.main(["--output_path", str(tmp_path / "port")] + args)
    assert len(out["objects"]) == 4 and sum(len(o) for o in out["objects"]) > 0
    _same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"), 4)
