"""The port's demos and overlays against the JAX package's, on the CPU at a
tiny width (32x32 crops, latent 16, 48 codebook rows): `box3d`,
`PoseVisualizer`, `plot_scene_with_3d_boxes`, `tiles4`, `lazy_property`,
and the CLIs `aae_image`, `aae_webcam` and `detector_webcam_pose` on one
experiment whose weights the JAX package drew and
`scripts/convert_jax_checkpoint.py` carried over (`convert.params_from_jax`).

The JAX CLIs run with cv2's camera and window monkeypatched, as the JAX
suite drives them; the port's get the same fakes through its seams
(`pose/webcam_video_stream`). Rotations and codebook rows are equal, poses
within 1e-4, pixels equal except inside the text boxes, where the port's
glyphs are not OpenCV 5's antialiased TrueType ones (ROADMAP C)."""

import os
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from augmentedautoencoder_tpu import factory as jax_factory  # noqa: E402
from augmentedautoencoder_torch import factory  # noqa: E402
from augmentedautoencoder_torch.geometry import transform  # noqa: E402

from _torch_port_ws import global_rng_guard, make_jax_workspace, write_procedural_mesh, write_test_cfg  # noqa: E402,F401

torch.set_num_threads(2)
FONT = cv2.FONT_HERSHEY_SIMPLEX
POSE_ATOL = 1e-4


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_demos")
    ply = write_procedural_mesh(root / "obj.ply")
    old = os.environ.get("AE_WORKSPACE_PATH")
    make_jax_workspace(root / "ws", {"obj": 3}, model_path=ply)
    if old is None:
        os.environ.pop("AE_WORKSPACE_PATH")
    else:
        os.environ["AE_WORKSPACE_PATH"] = old
    return {"root": root, "ws": str(root / "ws"), "ply": ply}


@pytest.fixture
def in_ws(ws, monkeypatch, tmp_path):
    monkeypatch.setenv("AE_WORKSPACE_PATH", ws["ws"])
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla_cache"))
    return ws


def _renderers(ply):
    from augmentedautoencoder_tpu.renderer import Renderer as JaxRenderer
    from augmentedautoencoder_tpu.renderer.mesh import load_mesh as jax_load_mesh
    from augmentedautoencoder_torch.renderer import Renderer, load_mesh

    return (JaxRenderer([], backend="native", meshes=[jax_load_mesh(ply)]),
            Renderer([], backend="native", meshes=[load_mesh(ply)]))


def _text_boxes(texts, H, W):
    """The union of cv2.getTextSize boxes, widened by the thickness."""
    mask = np.zeros((H, W), bool)
    for s, (x, y), scale, thickness in texts:
        (w, h), b = cv2.getTextSize(s, FONT, scale, thickness)
        mask[max(0, y - h - thickness):max(0, y + b + thickness + 1),
             max(0, x - thickness):max(0, x + w + thickness)] = True
    return mask


K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])


def _poses(seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        R = transform.random_rotation_matrix(rng.rand(3))[:3, :3]
        t = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40), rng.uniform(250, 450)])
        out.append((R, t))
    return out


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_draw_box3d_equals_the_jax_overlay(thickness):
    from augmentedautoencoder_tpu.visualization import box3d as jax_box3d
    from augmentedautoencoder_torch.visualization import box3d

    rng = np.random.RandomState(thickness)
    for R, t in _poses(thickness, 12):
        img = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
        lo, hi = -rng.uniform(20, 50, 3), rng.uniform(20, 50, 3)
        want = jax_box3d.draw_box3d(img, lo, hi, K, R, t, color=(0, 255, 0), thickness=thickness)
        got = box3d.draw_box3d(img, lo, hi, K, R, t, color=(0, 255, 0), thickness=thickness)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(box3d.box3d_corners(lo, hi), jax_box3d.box3d_corners(lo, hi))


def test_plot_scene_with_3d_boxes_writes_the_jax_pixels(tmp_path):
    from PIL import Image

    from augmentedautoencoder_tpu.evaluation import plots as jax_plots
    from augmentedautoencoder_torch.evaluation import plots

    rng = np.random.RandomState(0)
    scene = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    est, gt = _poses(5, 2), _poses(6, 2)
    for gray in (False, True):
        img = scene[..., 0] if gray else scene
        jax_plots.plot_scene_with_3d_boxes(img, K, [-30, -30, -30], [30, 30, 30], est, str(tmp_path / "j.png"), gt)
        plots.plot_scene_with_3d_boxes(img, K, [-30, -30, -30], [30, 30, 30], est, str(tmp_path / "p.png"), gt)
        want = np.asarray(Image.open(tmp_path / "j.png").convert("RGB"))
        got = np.asarray(Image.open(tmp_path / "p.png"))
        np.testing.assert_array_equal(got, want)


def test_pose_visualizer_equals_the_jax_overlay_outside_the_labels(ws):
    from augmentedautoencoder_tpu.pose.interfaces import BoundingBox as JaxBox, PoseEstimate as JaxEst
    from augmentedautoencoder_tpu.visualization import PoseVisualizer as JaxVisualizer
    from augmentedautoencoder_torch.pose import BoundingBox, PoseEstimate
    from augmentedautoencoder_torch.visualization import PoseVisualizer

    jax_r, port_r = _renderers(ws["ply"])
    rng = np.random.RandomState(1)
    for frame in range(3):
        img = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
        trafos = []
        for R, t in _poses(10 + frame, 2):
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = R, t / 1000.0
            trafos.append(T)
        boxes = [(0.1, 0.2, 0.5, 0.7, "obj"), (0.4, 0.05, 0.95, 0.6, "cup_2")]
        want = JaxVisualizer(jax_r, {"obj": 0}).render_poses(
            img, K, [JaxEst(name="obj", trafo=T) for T in trafos],
            [JaxBox(xmin=a, ymin=b, xmax=c, ymax=d, classes={n: 0.9}) for a, b, c, d, n in boxes])
        got = PoseVisualizer(port_r, {"obj": 0}).render_poses(
            img, K, [PoseEstimate(name="obj", trafo=T) for T in trafos],
            [BoundingBox(xmin=a, ymin=b, xmax=c, ymax=d, classes={n: 0.9}) for a, b, c, d, n in boxes])
        labels = _text_boxes([(n, (int(a * 128), max(int(b * 96) - 4, 10)), 0.5, 1) for a, b, c, d, n in boxes],
                             96, 128)
        diff = (got != want).any(-1)
        assert not (diff & ~labels).any()
        assert (got != img).any(-1).sum() > 100


def test_tiles4_and_lazy_property_equal_the_jax_helpers():
    from augmentedautoencoder_tpu.utils import misc as jax_misc
    from augmentedautoencoder_torch.utils import misc

    rng = np.random.RandomState(0)
    for n, rows, cols, scale in ((5, 2, 3, 1.0), (4, 2, 2, 0.5), (7, 2, 3, 2.0)):
        batch = rng.rand(n, 8, 6, 4)
        np.testing.assert_array_equal(misc.tiles4(batch, rows, cols, 2, 3, scale),
                                      jax_misc.tiles4(batch, rows, cols, 2, 3, scale))
    with pytest.raises(ValueError):
        misc.tiles4(rng.rand(2, 8, 6, 3), 1, 2)

    calls = []

    class Holder:
        @misc.lazy_property
        def value(self):
            calls.append(1)
            return 42

    h = Holder()
    assert h.value == 42 and h.value == 42 and len(calls) == 1


def _view(dataset, codebook, row, hw=None, offset=(0.0, 0.0)):
    cfg = dataset.cfg
    W, H = hw or cfg.render_dims
    frame, _ = dataset.renderer.render(0, W, H, cfg.K, codebook.viewsphere[row],
                                       np.array([offset[0], offset[1], cfg.radius]),
                                       cfg.clip_near, cfg.clip_far, random_light=False)
    return frame


def test_aae_image_equals_the_jax_demo(in_ws, tmp_path, monkeypatch):
    from augmentedautoencoder_tpu.cli import aae_image as jax_aae_image
    from augmentedautoencoder_torch.cli import aae_image

    codebook, dataset = factory.build_codebook_from_name("obj", return_dataset=True, device="cpu")
    src = tmp_path / "crops"
    src.mkdir()
    for row in (0, 7, 20, 33):
        crop = dataset.render_rot(codebook.viewsphere[row])
        cv2.imwrite(str(src / f"view_{row:02d}.png"), cv2.resize(crop, (48, 40)))
    monkeypatch.setattr(sys, "argv", ["aae_image", "obj", "-f", str(src), "-o", str(tmp_path / "jax")])
    jax_aae_image.main()
    results = aae_image.main(["obj", "-f", str(src), "-o", str(tmp_path / "port")], device="cpu")

    jax_codebook, _ = jax_factory.build_codebook_from_name("obj", return_dataset=True)
    assert len(results) == 4
    for r in results:
        crop = cv2.resize(cv2.imread(r["file"]), (32, 32))
        np.testing.assert_array_equal(r["R"], jax_codebook.nearest_rotation(crop))
        assert r["idx"] == int(jax_codebook.nearest_rotation(crop, return_idcs=True)[0])
        want = cv2.imread(str(tmp_path / "jax" / os.path.basename(r["out_path"])))
        got = cv2.imread(r["out_path"])
        assert got.shape == (32, 64, 3)
        np.testing.assert_array_equal(got, want)


class FakeCapture:
    """A camera serving `frames` in turn (the last one repeated)."""

    def __init__(self, frames):
        self.frames, self.i = frames, 0
        self.released = False
        self.props = {}

    def __call__(self, src):
        return self

    def set(self, prop, value):
        self.props[prop] = value

    def read(self):
        frame = self.frames[min(self.i, len(self.frames) - 1)]
        self.i += 1
        return True, frame.copy()

    def release(self):
        self.released = True


class FakeDisplay:
    def __init__(self, quit_after):
        self.shown, self.keys = [], 0
        self.quit_after = quit_after

    def imshow(self, name, img):
        self.shown.append((name, np.asarray(img).copy()))

    def wait_key(self, ms):
        self.keys += 1
        return ord("q") if self.keys >= self.quit_after else 255


def _patch_jax_cv2(monkeypatch, frame, quit_after):
    cap = FakeCapture([frame])
    shown = []
    monkeypatch.setattr(cv2, "VideoCapture", cap)
    monkeypatch.setattr(cv2, "imshow", lambda name, img: shown.append((name, np.asarray(img).copy())))
    keys = iter([255] * (quit_after - 1) + [ord("q")] * 4)
    monkeypatch.setattr(cv2, "waitKey", lambda ms: next(keys))
    return cap, shown


def test_aae_webcam_equals_the_jax_demo(in_ws, monkeypatch):
    from augmentedautoencoder_tpu.cli import aae_webcam as jax_aae_webcam
    from augmentedautoencoder_torch.cli import aae_webcam

    codebook, dataset = factory.build_codebook_from_name("obj", return_dataset=True, device="cpu")
    frame = _view(dataset, codebook, 5, hw=(160, 120))
    jax_cap, jax_shown = _patch_jax_cv2(monkeypatch, frame, 2)
    monkeypatch.setattr(sys, "argv", ["aae_webcam", "obj"])
    jax_aae_webcam.main()

    cap, display, records = FakeCapture([frame]), FakeDisplay(2), []
    aae_webcam.main(["obj"], device="cpu", capture=cap, display=display, records=records)
    assert cap.released and jax_cap.released
    assert cap.props == {3: 720, 4: 540}
    assert [n for n, _ in display.shown] == [n for n, _ in jax_shown]
    assert len(records) == 2
    for (_, got), (_, want) in zip(display.shown, jax_shown):
        np.testing.assert_array_equal(got, want)
    jax_codebook = jax_factory.build_codebook_from_name("obj")
    for r in records:
        assert r["idx"] == int(jax_codebook.nearest_rotation(r["crop"], return_idcs=True)[0])
        np.testing.assert_array_equal(r["R"], jax_codebook.nearest_rotation(r["crop"]))


def _two_object_frame(dataset, codebook):
    cfg = dataset.cfg
    W, H = 200, 150
    Kf = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]])
    bgr, depth, _ = dataset.renderer.render_many(
        [0, 0], W, H, Kf, [codebook.viewsphere[3], codebook.viewsphere[30]],
        [np.array([-70.0, 0.0, 300.0]), np.array([80.0, 30.0, 320.0])],
        cfg.clip_near, cfg.clip_far, random_light=False)
    return bgr, Kf


@pytest.mark.parametrize("label_map", [False, True], ids=["names", "label_map"])
def test_detector_webcam_pose_equals_the_jax_demo(in_ws, monkeypatch, tmp_path, label_map):
    from augmentedautoencoder_tpu.cli import detector_webcam_pose as jax_demo
    from augmentedautoencoder_tpu.pose import AePoseEstimator as JaxEstimator
    from augmentedautoencoder_tpu.pose import detectors as jax_detectors
    from augmentedautoencoder_tpu.pose import label_map as jax_label_map
    from augmentedautoencoder_torch.cli import detector_webcam_pose

    codebook, dataset = factory.build_codebook_from_name("obj", return_dataset=True, device="cpu")
    frame, Kf = _two_object_frame(dataset, codebook)
    test_cfg = write_test_cfg(tmp_path / "m3.cfg", {"obj": "obj"})
    cls = "1" if label_map else "obj"
    argv = [test_cfg, "--camK", ",".join(str(v) for v in Kf.ravel())]
    if label_map:
        (tmp_path / "labels.pbtxt").write_text("item {\n  id: 1\n  name: 'obj'\n}\n")
        argv += ["--label_map", str(tmp_path / "labels.pbtxt")]

    _, jax_shown = _patch_jax_cv2(monkeypatch, frame, 2)
    monkeypatch.setattr(sys, "argv", ["detector_webcam_pose"] + argv + [
        "--detector", "augmentedautoencoder_tpu.pose.detectors:ForegroundContourDetector:"
        f'{{"class_name": "{cls}", "thresh": 5}}'])
    jax_demo.main()

    cap, display, records = FakeCapture([frame]), FakeDisplay(2), []
    detector_webcam_pose.main(argv + [
        "--detector", "augmentedautoencoder_torch.pose.detectors:ForegroundContourDetector:"
        f'{{"class_name": "{cls}", "thresh": 5}}'], device="cpu", capture=cap, display=display,
        records=records)
    assert cap.released and len(records) == 2 and len(jax_shown) == 2

    want_boxes = jax_detectors.ForegroundContourDetector(class_name=cls, thresh=5).process(frame)
    if label_map:
        jax_label_map.remap_box_classes(want_boxes, {1: {"id": 1, "name": "obj"}})
    want_poses = JaxEstimator(test_cfg).process(bboxes=want_boxes, color_img=frame, camK=Kf)
    assert len(want_boxes) == 2 and len(want_poses) == 2
    for r, (_, shown) in zip(records, jax_shown):
        assert [(b.xmin, b.ymin, b.xmax, b.ymax, b.classes) for b in r["boxes"]] == \
            [(b.xmin, b.ymin, b.xmax, b.ymax, b.classes) for b in want_boxes]
        assert [p.name for p in r["poses"]] == [p.name for p in want_poses]
        for p, q in zip(r["poses"], want_poses):
            np.testing.assert_allclose(p.trafo, q.trafo, rtol=0, atol=POSE_ATOL)
        texts = [(f"{p.name} z={p.trafo[2, 3]:.2f}m", (10, 20), 0.6, 2) for p in want_poses]
        diff = (r["overlay"] != shown).any(-1)
        assert not (diff & ~_text_boxes(texts, *frame.shape[:2])).any()
        assert set(r["ms"]) == {"detect", "estimate", "draw"}


def test_the_camera_and_window_seams_refuse_without_opencv(in_ws, monkeypatch, tmp_path):
    from augmentedautoencoder_torch.cli import aae_webcam, detector_webcam_pose
    from augmentedautoencoder_torch.pose import webcam_video_stream as wvs

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="no camera backend"):
        wvs.WebcamVideoStream(0)
    with pytest.raises(RuntimeError, match="no window backend"):
        wvs.OpenCVDisplay()
    with pytest.raises(RuntimeError, match="no camera backend"):
        aae_webcam.main(["obj"], device="cpu")
    cap = FakeCapture([np.zeros((48, 64, 3), np.uint8)])
    with pytest.raises(RuntimeError, match="no window backend"):
        aae_webcam.main(["obj"], device="cpu", capture=cap)
    assert cap.released
    cap = FakeCapture([np.zeros((48, 64, 3), np.uint8)])
    test_cfg = write_test_cfg(tmp_path / "m3.cfg", {"obj": "obj"})
    with pytest.raises(RuntimeError, match="no window backend"):
        detector_webcam_pose.main([test_cfg, "--detector", "augmentedautoencoder_torch.pose.detectors:"
                                   "ForegroundContourDetector"], device="cpu", capture=cap)
    assert cap.released
