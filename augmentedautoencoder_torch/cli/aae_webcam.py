"""`python -m augmentedautoencoder_torch.cli.aae_webcam <group>/<experiment>`
-- live rotation estimation demo (port of augmentedautoencoder_tpu/cli/
aae_webcam.py; reference auto_pose/test/aae_webcam.py).

Reads camera frames (threaded grabber), center-crops, resizes with
`pose.estimator.resize_linear_u8`, estimates the nearest codebook rotation
(encoder + the top-1 codebook query on the device) and shows the input
beside the re-rendered estimate; 'q' quits. The camera and the window come
through the seams of `pose/webcam_video_stream` (OpenCV by default, which
this module never imports): `main(argv, device, capture=..., display=...)`.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional, Sequence

import numpy as np

from .. import factory
from ..codebook import f32_without_tf32
from ..pose.estimator import resize_linear_u8
from ..pose.webcam_video_stream import OpenCVDisplay, WebcamVideoStream
from . import split_experiment_name


def center_crop(frame: np.ndarray) -> np.ndarray:
    H, W = frame.shape[:2]
    side = min(H, W)
    return frame[(H - side) // 2:(H + side) // 2, (W - side) // 2:(W + side) // 2]


def main(argv: Optional[Sequence[str]] = None, device=None, capture: Optional[Callable] = None,
         display=None, records: Optional[List] = None) -> None:
    """`records`, where given, receives per shown frame its crop, codebook
    row and rotation."""
    parser = argparse.ArgumentParser(prog="aae_webcam")
    parser.add_argument("experiment_name")
    parser.add_argument("--src", type=int, default=0)
    parser.add_argument("--down", type=int, default=1, help="render downsample")
    args = parser.parse_args(argv)

    experiment_name, experiment_group = split_experiment_name(args.experiment_name)
    codebook, dataset = factory.build_codebook_from_name(
        experiment_name, experiment_group, return_dataset=True, device=device
    )
    h, w = dataset.shape[:2]

    videoStream = WebcamVideoStream(args.src, 720, 540, capture=capture).start()
    try:
        display = display or OpenCVDisplay()
        while True:
            frame = videoStream.read()
            if frame is None:
                continue
            crop = resize_linear_u8(center_crop(frame), (w, h))
            with f32_without_tf32():
                idx = int(codebook.nearest_rotation(crop, return_idcs=True)[0])
            R = codebook.viewsphere[idx]
            pred_view = dataset.render_rot(R, downSample=args.down)
            display.imshow("resized webcam input", crop)
            display.imshow("estimated rendered view", pred_view.astype(np.uint8))
            if records is not None:
                records.append({"crop": crop, "idx": idx, "R": R})
            if display.wait_key(1) & 0xFF == ord("q"):
                break
    finally:
        videoStream.stop()


if __name__ == "__main__":
    main()
