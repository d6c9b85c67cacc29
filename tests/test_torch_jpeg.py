"""The background JPEG decode of the port (augmentedautoencoder_torch/data/dataset.py
`decode_bgr`, PIL) against OpenCV's, on the committed fixture
tests/fixtures/torch_port/background_q95_420.jpg: written by cv2.imwrite at
its defaults (quality 95, baseline, 4:2:0, as VOC's JPEGs are) by
make_jpeg_fixture.py beside it, with cv2.imread's decode stored as .npy.
chip_smoke.py phase 10 makes the same check on the card's machine, whose
Pillow may carry another libjpeg."""

import os

import numpy as np
import pytest
from PIL import Image

from augmentedautoencoder_tpu.config import load_train_config as jax_load_train_config
from augmentedautoencoder_tpu.data.dataset import Dataset as JaxDataset
from augmentedautoencoder_torch.config import load_train_config
from augmentedautoencoder_torch.data.dataset import Dataset, decode_bgr

from _torch_port_ws import TINY_CFG

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_port")
JPEG = os.path.join(FIXTURES, "background_q95_420.jpg")
DECODED = os.path.join(FIXTURES, "background_q95_420_cv2.npy")


def test_fixture_decodes_to_the_stored_cv2_bytes():
    want = np.load(DECODED)
    got = decode_bgr(JPEG)
    assert got.shape == want.shape == (96, 128, 3) and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_fixture_is_a_baseline_420_jpeg():
    with Image.open(JPEG) as im:
        assert im.format == "JPEG" and im.mode == "RGB" and not im.info.get("progressive")
        # (component id, horizontal, vertical sampling, quant table): luma 2x2, chroma 1x1
        assert [layer[1:3] for layer in im.layer] == [(2, 2), (1, 1), (1, 1)]


def test_fixture_decodes_as_cv2_does_now():
    cv2 = pytest.importorskip("cv2")
    np.testing.assert_array_equal(decode_bgr(JPEG), cv2.imread(JPEG))


@pytest.mark.parametrize("channels", [3, 1])
def test_fixture_as_a_background_matches_jax(tmp_path, channels):
    """load_bg_images on the fixture (random crop; gray for C 1) gives the
    JAX package's cv2 path's bytes from the same seed."""
    cfg_path = str(tmp_path / "bg.cfg")
    with open(cfg_path, "w") as fh:
        fh.write(TINY_CFG.replace("/nonexistent/*.jpg", JPEG).replace("NOOF_BG_IMGS: 0", "NOOF_BG_IMGS: 1")
                 .replace("C: 3", f"C: {channels}"))
    jds = JaxDataset(str(tmp_path / "jax"), jax_load_train_config(cfg_path))
    np.random.seed(31)
    jds.load_bg_images(str(tmp_path / "jax"))
    tds = Dataset(str(tmp_path / "port"), load_train_config(cfg_path))
    tds.load_bg_images(str(tmp_path / "port"), np.random.RandomState(31))
    assert tds.bg_imgs.shape == (1, 32, 32, channels)
    np.testing.assert_array_equal(tds.bg_imgs, jds.bg_imgs)
