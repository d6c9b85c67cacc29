"""The port's embedding dataset (augmentedautoencoder_torch/data/dataset.py)
against cv2 and the JAX package: the crop's resize and the 1-channel
conversion bit for bit as cv2 computes them, and the embedding renders
(crops and boxes) bit for bit as the JAX `Dataset` renders them.

The JAX `Dataset` is always given a `Renderer` built here, once: its own
lazily built renderer is raced by its render threads."""

import os
import threading

import cv2
import numpy as np
import pytest

from augmentedautoencoder_tpu.config import load_train_config as jax_load_train_config
from augmentedautoencoder_tpu.data.dataset import Dataset as JaxDataset
from augmentedautoencoder_tpu.data.dataset import extract_square_patch as jax_extract_square_patch
from augmentedautoencoder_tpu.renderer import Renderer as JaxRenderer
from augmentedautoencoder_torch import factory
from augmentedautoencoder_torch.config import load_train_config
from augmentedautoencoder_torch.data import dataset as tds

from _torch_port_ws import TINY_CFG, write_procedural_mesh


@pytest.fixture(scope="module")
def cfg_paths(tmp_path_factory):
    """A 3-channel and a 1-channel cfg rendering a procedural mesh."""
    root = tmp_path_factory.mktemp("torch_dataset")
    ply = write_procedural_mesh(root / "obj.ply")
    paths = {}
    for c in (3, 1):
        text = TINY_CFG.replace("/nonexistent/model.ply", ply).replace("C: 3", f"C: {c}")
        paths[c] = str(root / f"c{c}.cfg")
        with open(paths[c], "w") as fh:
            fh.write(text)
    return str(root), paths


def _jax_dataset(root, cfg_path):
    cfg = jax_load_train_config(cfg_path)
    renderer = JaxRenderer([cfg.model_path], samples=cfg.antialiasing, vertex_tmp_store_folder=root,
                           vertex_scale=cfg.vertex_scale, backend="native")
    return JaxDataset(root, cfg, renderer=renderer)


@pytest.mark.parametrize("channels", [3, 1])
def test_resize_nearest_is_cv2_inter_nearest(channels):
    rng = np.random.RandomState(channels)
    for _ in range(200):
        h, w = rng.randint(1, 400, 2)
        shape = (h, w, 3) if channels == 3 else (h, w)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        dsize = (int(rng.choice([128, 64, 37])), int(rng.choice([128, 96, 41])))
        want = cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(tds.resize_nearest(img, dsize), want)
    depth = rng.rand(97, 61).astype(np.float32)  # the training path crops depth too
    np.testing.assert_array_equal(tds.resize_nearest(depth, (128, 128)),
                                  cv2.resize(depth, (128, 128), interpolation=cv2.INTER_NEAREST))


def test_bgr_to_gray_is_cv2_on_every_bgr_triple():
    v = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(tds.bgr_to_gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("interpolation", ["nearest", "linear"])
@pytest.mark.parametrize("black_borders", [False, True])
def test_extract_square_patch_matches_jax_and_cv2(interpolation, black_borders):
    """The same integer geometry as the JAX function (which resizes with
    cv2): boxes inside, at and over the image edges, odd sizes, and pad
    factors that crop past the image."""
    rng = np.random.RandomState(int(black_borders) * 2 + (interpolation == "linear"))
    img = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    boxes = [(40, 30, 20, 24), (0, 0, 33, 17), (100, 70, 28, 26), (-5, 10, 30, 40), (60.7, 20.2, 15.9, 41.3)]
    boxes += [tuple(rng.randint(-10, 90, 2)) + tuple(rng.randint(4, 70, 2)) for _ in range(30)]
    for box in boxes:
        for pad, resize in ((1.2, (32, 32)), (1.0, (17, 23)), (2.5, (128, 128))):
            want = jax_extract_square_patch(img, box, pad, resize=resize, interpolation=interpolation,
                                            black_borders=black_borders)
            got = tds.extract_square_patch(img, box, pad, resize=resize, interpolation=interpolation,
                                           black_borders=black_borders)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_extract_square_patch_takes_depth_and_refuses_linear_floats():
    depth = np.random.RandomState(0).rand(96, 128).astype(np.float32)
    np.testing.assert_array_equal(tds.extract_square_patch(depth, (30, 20, 40, 35), 1.2, resize=(32, 32)),
                                  jax_extract_square_patch(depth, (30, 20, 40, 35), 1.2, resize=(32, 32)))
    with pytest.raises(ValueError, match="uint8"):
        tds.extract_square_patch(depth, (30, 20, 40, 35), 1.2, interpolation="linear")


@pytest.mark.parametrize("channels", [3, 1])
def test_embedding_batch_matches_jax_bit_for_bit(cfg_paths, channels):
    root, paths = cfg_paths
    port = tds.Dataset(root, load_train_config(paths[channels]))
    ref = _jax_dataset(root, paths[channels])
    assert port.embedding_size == ref.embedding_size == 48
    np.testing.assert_array_equal(port.viewsphere_for_embedding, ref.viewsphere_for_embedding)
    for a, e in ((0, 48), (13, 20)):
        x, bbs = port.render_embedding_image_batch(a, e)
        jx, jbbs = ref.render_embedding_image_batch(a, e)
        assert x.dtype == np.uint8 and x.shape == (e - a, 32, 32, channels)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(bbs, jbbs)
        assert bbs.dtype == jbbs.dtype
    R = ref.viewsphere_for_embedding[7]
    np.testing.assert_array_equal(port.render_rot(R, downSample=2), ref.render_rot(R, downSample=2))


def test_dataset_builds_one_renderer_under_a_lock(cfg_paths):
    """Eight threads asking for the renderer at once get one object, with
    one mesh registration, and a batch rendered on 8 threads equals one
    rendered on 1."""
    root, paths = cfg_paths
    ds = factory.build_dataset(root, load_train_config(paths[3]), render_workers=8)
    assert ds.render_workers == 8 and ds._renderer is None
    got, barrier = [], threading.Barrier(8)

    def ask():
        barrier.wait(timeout=60)
        got.append(ds.renderer)

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and len(got) == 8
    assert all(r is got[0] for r in got) and got[0].backend == "native"
    serial = tds.Dataset(root, load_train_config(paths[3]), renderer=got[0], render_workers=1)
    for a, b in zip(ds.render_embedding_image_batch(0, 24), serial.render_embedding_image_batch(0, 24)):
        np.testing.assert_array_equal(a, b)


def test_dataset_renderer_follows_the_cfg(cfg_paths, tmp_path):
    """MODEL cad shades with the CAD material, ANTIALIASING 2 supersamples,
    MAX_RENDER_FACES decimates, and the mesh cache lands in the dataset
    path."""
    root, paths = cfg_paths
    with open(paths[3]) as fh:
        text = fh.read()
    text = (text.replace("MODEL: reconst", "MODEL: cad").replace("ANTIALIASING: 1", "ANTIALIASING: 2")
            .replace("PAD_FACTOR: 1.2", "MAX_RENDER_FACES: 120\nPAD_FACTOR: 1.2"))
    path = tmp_path / "cad.cfg"
    path.write_text(text)
    cache = tmp_path / "cache"
    port = tds.Dataset(str(cache), load_train_config(str(path)))
    jcfg = jax_load_train_config(str(path))
    ref = JaxDataset(str(cache), jcfg, renderer=JaxRenderer(
        [jcfg.model_path], samples=2, vertex_tmp_store_folder=str(cache), vertex_scale=1.0,
        backend="native", shading="cad", max_faces=120))
    assert len(port.renderer._meshes[0].faces) <= 120
    assert len(os.listdir(cache)) == 1
    for a, b in zip(port.render_embedding_image_batch(0, 12), ref.render_embedding_image_batch(0, 12)):
        np.testing.assert_array_equal(a, b)
