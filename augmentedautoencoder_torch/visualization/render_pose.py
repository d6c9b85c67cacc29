"""Pose-estimate overlay (port of augmentedautoencoder_tpu/visualization/
render_pose.py; reference auto_pose/visualization/render_pose.py).

Renders all estimated objects into the scene with `render_many`, blends the
green channel over the camera image where the render is visible (float64,
as the JAX code computes it), and draws the detection boxes and class
labels with `utils/draw` (OpenCV's rectangle pixels; the label's glyphs may
differ from `cv2.putText`'s inside its text box).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..utils import draw


class PoseVisualizer:
    def __init__(self, renderer, class_to_obj_id: Optional[Dict] = None,
                 clip_near: float = 10.0, clip_far: float = 10000.0):
        """renderer: a facade Renderer holding ALL object models;
        class_to_obj_id maps PoseEstimate.name -> renderer object index."""
        self.renderer = renderer
        self.class_to_obj_id = class_to_obj_id or {}
        self.clip_near = clip_near
        self.clip_far = clip_far

    def render_poses(
        self,
        image: np.ndarray,
        camK: np.ndarray,
        pose_estimates: Sequence,
        bboxes: Sequence = (),
        in_meters: bool = True,
        alpha: float = 2.0 / 3.0,
    ) -> np.ndarray:
        """Overlay pose estimates on the BGR image; returns a new image."""
        H, W = image.shape[:2]
        out = image.copy()

        obj_ids, Rs, ts = [], [], []
        for est in pose_estimates:
            obj_ids.append(self.class_to_obj_id.get(est.name, 0))
            Rs.append(est.trafo[:3, :3])
            t = est.trafo[:3, 3]
            ts.append(t * 1000.0 if in_meters else t)

        if obj_ids:
            bgr, depth, _ = self.renderer.render_many(
                obj_ids, W, H, np.asarray(camK, np.float64), Rs, ts,
                self.clip_near, self.clip_far, random_light=False,
            )
            g = np.zeros_like(bgr)
            g[:, :, 1] = bgr[:, :, 1]
            vis = depth > 0
            out[vis] = (g[vis] * alpha + out[vis] * (1.0 - alpha)).astype(np.uint8)

        for box in bboxes:
            x0, y0 = int(box.xmin * W), int(box.ymin * H)
            x1, y1 = int(box.xmax * W), int(box.ymax * H)
            draw.rectangle(out, (x0, y0), (x1, y1), (0, 255, 0), 2)
            draw.put_text(out, str(box.best_class), (x0, max(y0 - 4, 10)), 0.5, (0, 255, 0), 1)
        return out
