"""Geometry & SO(3) math: view-sphere sampling, transforms, projections."""

from . import transform, view_sampler
from .misc import calc_2d_bbox, project_pts, rgbd_to_point_cloud

__all__ = [
    "transform",
    "view_sampler",
    "calc_2d_bbox",
    "project_pts",
    "rgbd_to_point_cloud",
]
