"""Shipped concrete `BoundingBoxDetector` implementations (port of
augmentedautoencoder_tpu/pose/detectors.py).

The demo CLI takes ANY `BoundingBoxDetector` by dotted path
(`detector_webcam_pose --detector pkg.module:Class[:json_kwargs]`); this
module provides the dependency-free one:

  * `ForegroundContourDetector` -- connected-components detection on a
    foreground mask (fixed dark background, a reference background frame,
    or a depth image), through `utils/draw`'s opening and labelling, which
    give OpenCV's pixels and label order, so the boxes and their order are
    the JAX detector's.

Example:
    python -m augmentedautoencoder_torch.cli.detector_webcam_pose m3.cfg --detector \
        augmentedautoencoder_torch.pose.detectors:ForegroundContourDetector:'{"class_name": "obj1"}'
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils import draw
from .interfaces import BoundingBox, BoundingBoxDetector


class ForegroundContourDetector(BoundingBoxDetector):
    """Connected-component boxes from a foreground mask.

    Foreground = pixels brighter than `thresh` (after optional background
    subtraction via `set_background`), or depth > 0 when `process_raw`
    receives a single-channel float/uint16 image. Components smaller than
    `min_area` pixels are dropped; every box carries `{class_name: score}`
    with score = the component's fill ratio inside its box; boxes are sorted
    by it (a stable sort: equal ratios keep the label order) and cut at
    `max_detections`.
    """

    def __init__(
        self,
        class_name: str = "obj",
        thresh: float = 15.0,
        min_area: int = 64,
        max_detections: int = 16,
        pad: float = 0.0,
    ):
        super().__init__()
        self.class_name = str(class_name)
        self.thresh = float(thresh)
        self.min_area = int(min_area)
        self.max_detections = int(max_detections)
        self.pad = float(pad)  # relative box padding on each side
        self._background: Optional[np.ndarray] = None

    # -- BoundingBoxDetector contract -------------------------------------
    def preprocess_image(self, image, color_format_in="bgr", type_in=np.uint8):
        """The classical pipeline is colorspace-agnostic; pass through."""
        return np.asarray(image)

    def set_background(self, background: np.ndarray) -> None:
        """Reference frame for background subtraction (e.g. the empty
        scene); without one, foreground = brightness > thresh."""
        self._background = np.asarray(background).astype(np.int16)

    def _foreground_mask(self, image: np.ndarray) -> np.ndarray:
        img = np.asarray(image)
        if img.ndim == 2 and img.dtype != np.uint8:
            return img > 0  # depth image: valid depth is foreground
        if img.ndim == 3:
            gray = img.astype(np.int16).max(axis=2)
        else:
            gray = img.astype(np.int16)
        if self._background is not None:
            bg = self._background
            bg = bg.max(axis=2) if bg.ndim == 3 else bg
            return np.abs(gray - bg) > self.thresh
        return gray > self.thresh

    def process_raw(self, image) -> List[BoundingBox]:
        mask = self._foreground_mask(image).astype(np.uint8)
        H, W = mask.shape[:2]
        mask = draw.morph_open3x3(mask)  # open small speckle before labelling
        boxes = []
        for x, y, w, h, area in draw.connected_components_stats(mask)[1:]:  # 0 is background
            if area < self.min_area:
                continue
            px, py = self.pad * w, self.pad * h
            xmin = max(0.0, (x - px) / W)
            ymin = max(0.0, (y - py) / H)
            xmax = min(1.0, (x + w + px) / W)
            ymax = min(1.0, (y + h + py) / H)
            boxes.append(
                BoundingBox(
                    xmin=xmin, ymin=ymin, xmax=xmax, ymax=ymax,
                    classes={self.class_name: float(area) / float(w * h)},
                )
            )
        boxes.sort(key=lambda b: b.classes[self.class_name], reverse=True)
        return boxes[: self.max_detections]
