"""6D pose estimation API of the port (the m3vision-style surface)."""

from .estimator import AePoseEstimator, extract_square_patch_centered
from .interfaces import BoundingBox, BoundingBoxDetector, PoseEstimate, PoseEstInterface, Roi3D

__all__ = [
    "AePoseEstimator",
    "BoundingBox",
    "BoundingBoxDetector",
    "PoseEstimate",
    "PoseEstInterface",
    "Roi3D",
    "extract_square_patch_centered",
]
