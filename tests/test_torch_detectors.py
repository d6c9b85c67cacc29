"""The port's detector and label map against the JAX package's
(`pose/detectors.ForegroundContourDetector`, `pose/label_map`): the same
`BoundingBox` list, field for field and in the same order, on seeded
random frames, including frames whose blobs tie in fill ratio, where the
stable sort keeps OpenCV's label order."""

import numpy as np
import pytest

pytest.importorskip("cv2")

from augmentedautoencoder_tpu.pose import detectors as jax_detectors  # noqa: E402
from augmentedautoencoder_tpu.pose import label_map as jax_label_map  # noqa: E402
from augmentedautoencoder_torch.pose import detectors, label_map  # noqa: E402


def _blob_frame(rng, H, W, n_blobs, channels=3):
    img = np.zeros((H, W, channels) if channels else (H, W), np.uint8)
    for _ in range(n_blobs):
        h, w = int(rng.integers(4, H // 2)), int(rng.integers(4, W // 2))
        y, x = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
        img[y:y + h, x:x + w] = rng.integers(20, 256)
        if rng.random() < 0.5:  # a notch: fill ratios below 1
            img[y:y + h // 2, x:x + w // 3] = 0
    noise = rng.random(img.shape[:2]) < 0.02  # speckle the opening removes
    img[noise] = 200
    return img


def _same_boxes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.xmin, g.ymin, g.xmax, g.ymax) == (w.xmin, w.ymin, w.xmax, w.ymax)
        assert g.classes == w.classes


@pytest.mark.parametrize("kwargs", [
    {},
    {"thresh": 40.0, "min_area": 16},
    {"pad": 0.1, "max_detections": 3},
    {"min_area": 1, "max_detections": 64},
], ids=["default", "thresh", "pad_cut", "all"])
def test_boxes_equal_the_jax_detector(kwargs):
    rng = np.random.default_rng(0)
    jax_det = jax_detectors.ForegroundContourDetector(class_name="obj", **kwargs)
    det = detectors.ForegroundContourDetector(class_name="obj", **kwargs)
    n_boxes = 0
    for _ in range(60):
        H, W = int(rng.integers(24, 90)), int(rng.integers(24, 120))
        img = _blob_frame(rng, H, W, int(rng.integers(1, 9)), channels=int(rng.choice([0, 3])))
        want = jax_det.process(img)
        _same_boxes(det.process(img), want)
        n_boxes += len(want)
    assert n_boxes > 60


def test_ties_in_fill_ratio_keep_the_label_order():
    """Full rectangles all score 1.0: the order is OpenCV's label order."""
    rng = np.random.default_rng(1)
    det = detectors.ForegroundContourDetector(min_area=4, max_detections=5)
    jax_det = jax_detectors.ForegroundContourDetector(min_area=4, max_detections=5)
    for _ in range(40):
        img = np.zeros((64, 80), np.uint8)
        for _ in range(8):
            h, w = int(rng.integers(3, 10)), int(rng.integers(3, 10))
            y, x = int(rng.integers(0, 64 - h)), int(rng.integers(0, 80 - w))
            img[y:y + h, x:x + w] = 255
        want = jax_det.process(img)
        _same_boxes(det.process(img), want)


def test_background_subtraction_and_depth_equal_the_jax_detector():
    rng = np.random.default_rng(2)
    for _ in range(20):
        bg = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        img = bg.copy()
        img[10:30, 12:40] = np.clip(bg[10:30, 12:40].astype(int) + 60, 0, 255)
        det, jax_det = detectors.ForegroundContourDetector(), jax_detectors.ForegroundContourDetector()
        det.set_background(bg)
        jax_det.set_background(bg)
        _same_boxes(det.process(img), jax_det.process(img))
        depth = np.where(rng.random((48, 64)) < 0.3, 0.0, rng.uniform(300, 900, (48, 64))).astype(np.float32)
        depth[5:25, 5:25] = 500.0
        _same_boxes(det.process(depth), jax_det.process(depth))


PBTXT = """
# a label map as the TF object detection API writes it
item {
  id: 1
  name: 'obj_000001'
  display_name: "duck"
}
item { id: 2 name: "obj_000002" }
item {
  id: 7
  name: 'obj_000007'
  display_name: 'can\\'s'
}
"""


@pytest.mark.parametrize("use_display_name", [True, False])
def test_label_map_equals_the_jax_module(tmp_path, use_display_name):
    path = tmp_path / "labels.pbtxt"
    path.write_text(PBTXT)
    assert label_map.load_labelmap(str(path)) == jax_label_map.load_labelmap(str(path))
    for max_classes in (2, 100):
        assert (label_map.create_category_index_from_labelmap(str(path), max_classes, use_display_name)
                == jax_label_map.create_category_index_from_labelmap(str(path), max_classes, use_display_name))
    index = label_map.create_category_index_from_labelmap(str(path))
    from augmentedautoencoder_tpu.pose.interfaces import BoundingBox as JaxBox
    from augmentedautoencoder_torch.pose import BoundingBox

    def boxes(cls):
        return [cls(xmin=0.1, ymin=0.1, xmax=0.5, ymax=0.6, classes={1: 0.9, "2": 0.5, "x": 0.1, 9: 0.3})]

    got = label_map.remap_box_classes(boxes(BoundingBox), index)
    want = jax_label_map.remap_box_classes(boxes(JaxBox), jax_label_map.create_category_index_from_labelmap(str(path)))
    assert [b.classes for b in got] == [b.classes for b in want]


def test_label_map_refuses_what_the_jax_module_refuses(tmp_path):
    for text in ("item { id: 0 name: 'bg' }", "item { id: 1 ", "other { id: 1 }"):
        path = tmp_path / "bad.pbtxt"
        path.write_text(text)
        with pytest.raises(ValueError):
            jax_label_map.load_labelmap(str(path))
        with pytest.raises(ValueError):
            label_map.load_labelmap(str(path))
