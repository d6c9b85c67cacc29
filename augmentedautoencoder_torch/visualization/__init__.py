"""Visualization: pose overlays and 3D box overlays (port of
augmentedautoencoder_tpu/visualization)."""

from .render_pose import PoseVisualizer

__all__ = ["PoseVisualizer"]
