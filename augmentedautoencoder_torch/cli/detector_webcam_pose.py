"""`python -m augmentedautoencoder_torch.cli.detector_webcam_pose <m3_cfg>
--detector pkg.module:Class` -- live 6D demo (port of augmentedautoencoder_tpu/
cli/detector_webcam_pose.py; reference test/aae_retina_webcam_pose.py,
test/aae_googledet_webcam_multi.py).

Any `BoundingBoxDetector`, loaded by dotted path, feeds the multi-codebook
`AePoseEstimator` (encoder + the top-1 codebook query per class on the
device); a `.pbtxt` label map renames integer class ids; boxes and pose
labels are drawn with `utils/draw`. A two-stage thread pipeline: the
detector runs one frame ahead of the pose stage. The camera and the window
come through the seams of `pose/webcam_video_stream`:
`main(argv, device, capture=..., display=..., records=...)`.
"""

from __future__ import annotations

import argparse
import importlib
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..codebook import f32_without_tf32
from ..pose import AePoseEstimator
from ..pose.webcam_video_stream import OpenCVDisplay, WebcamVideoStream
from ..utils import draw


def load_detector(spec: str):
    """'package.module:ClassName[:json_kwargs]' -> instance."""
    module_name, _, rest = spec.partition(":")
    class_name, _, kwargs_json = rest.partition(":")
    cls = getattr(importlib.import_module(module_name), class_name)
    kwargs = {}
    if kwargs_json:
        import json

        kwargs = json.loads(kwargs_json)
    return cls(**kwargs)


def draw_overlay(frame: np.ndarray, boxes, poses) -> np.ndarray:
    """The demo's overlay: detection rectangles and one label per pose."""
    H, W = frame.shape[:2]
    out = frame.copy()
    for box in boxes:
        x0, y0 = int(box.xmin * W), int(box.ymin * H)
        x1, y1 = int(box.xmax * W), int(box.ymax * H)
        draw.rectangle(out, (x0, y0), (x1, y1), (0, 255, 0), 2)
    for pose in poses:
        t = pose.trafo[:3, 3]
        draw.put_text(out, f"{pose.name} z={t[2]:.2f}m", (10, 20), 0.6, (0, 255, 0), 2)
    return out


def main(argv: Optional[Sequence[str]] = None, device=None, capture: Optional[Callable] = None,
         display=None, records: Optional[List] = None) -> None:
    """`records`, where given, receives per shown frame the frame, boxes,
    poses, overlay and the host milliseconds of detect, estimate and draw."""
    parser = argparse.ArgumentParser(prog="detector_webcam_pose")
    parser.add_argument("test_config")
    parser.add_argument("--detector", required=True,
                        help="dotted path pkg.module:Class of a BoundingBoxDetector")
    parser.add_argument("--src", type=int, default=0)
    parser.add_argument("--camK", default=None,
                        help="9 comma-separated intrinsics; defaults to a "
                             "focal ~ width pinhole")
    parser.add_argument("--label_map", default=None,
                        help=".pbtxt label map mapping integer detector class "
                             "ids to the estimator's class names")
    args = parser.parse_args(argv)

    detector = load_detector(args.detector)
    estimator = AePoseEstimator(args.test_config, device=device)
    category_index = None
    if args.label_map:
        from ..pose.label_map import create_category_index_from_labelmap, remap_box_classes

        category_index = create_category_index_from_labelmap(args.label_map)

    stream = WebcamVideoStream(args.src, 720, 540, capture=capture).start()
    det_queue: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    failure = []

    def detect_loop():
        try:
            detect_frames()
        except BaseException as exc:  # handed to the pose stage, which raises it
            failure.append(exc)

    def detect_frames():
        while not stop.is_set():
            frame = stream.read()
            if frame is None:
                time.sleep(0.01)
                continue
            t0 = time.perf_counter()
            boxes = detector.process(frame)
            if category_index is not None:
                remap_box_classes(boxes, category_index)
            detect_ms = (time.perf_counter() - t0) * 1e3
            try:
                det_queue.put((frame, boxes, detect_ms), timeout=0.5)
            except queue.Full:
                pass

    worker = threading.Thread(target=detect_loop, daemon=True)
    try:
        display = display or OpenCVDisplay()
        worker.start()
        while True:
            try:
                frame, boxes, detect_ms = det_queue.get(timeout=0.5)
            except queue.Empty:
                if failure:
                    raise RuntimeError("the detector stage failed") from failure[0]
                continue
            H, W = frame.shape[:2]
            if args.camK:
                camK = np.array([float(v) for v in args.camK.split(",")]).reshape(3, 3)
            else:
                camK = np.array([[W, 0, W / 2], [0, W, H / 2], [0, 0, 1.0]])
            t0 = time.perf_counter()
            with f32_without_tf32():
                poses = estimator.process(bboxes=boxes, color_img=frame, camK=camK)
            t1 = time.perf_counter()
            out = draw_overlay(frame, boxes, poses)
            t2 = time.perf_counter()
            display.imshow("6D pose", out)
            if records is not None:
                records.append({"frame": frame, "boxes": boxes, "poses": poses, "overlay": out,
                                "camK": camK, "ms": {"detect": detect_ms, "estimate": (t1 - t0) * 1e3,
                                                     "draw": (t2 - t1) * 1e3}})
            if display.wait_key(1) & 0xFF == ord("q"):
                break
    finally:
        stop.set()
        if worker.is_alive():
            worker.join(timeout=1.0)
        stream.stop()


if __name__ == "__main__":
    main()
