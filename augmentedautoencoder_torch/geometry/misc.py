"""Projection / point-cloud helpers (reference auto_pose/ae/pysixd_stuff/misc.py)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def calc_2d_bbox(xs: np.ndarray, ys: np.ndarray, im_size: Sequence[int]) -> List[float]:
    from .view_sampler import calc_2d_bbox as _impl

    return _impl(xs, ys, im_size)


def project_pts(pts: np.ndarray, K: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Project 3D model points to 2D pixels: x = K (R p + t)
    (reference misc.py project_pts)."""
    pts = np.asarray(pts, dtype=np.float64)
    P = K @ np.hstack([R, t.reshape(3, 1)])
    pts_h = np.hstack([pts, np.ones((pts.shape[0], 1))])
    pix = (P @ pts_h.T).T
    return pix[:, :2] / pix[:, 2:3]


def rgbd_to_point_cloud(K: np.ndarray, depth: np.ndarray):
    """Back-project a depth image to a 3D point cloud
    (reference misc.py:28-43). Returns (pts [N,3], (ys, xs))."""
    vs, us = depth.nonzero()
    zs = depth[vs, us]
    xs = (us - K[0, 2]) * zs / K[0, 0]
    ys = (vs - K[1, 2]) * zs / K[1, 1]
    pts = np.stack([xs, ys, zs], axis=1)
    return pts, (vs, us)


def depth_im_to_dist_im(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Convert a z-depth image into a ray-distance image (used by VSD)."""
    us, vs = np.meshgrid(np.arange(depth.shape[1]), np.arange(depth.shape[0]))
    xs = (us - K[0, 2]) * depth / K[0, 0]
    ys = (vs - K[1, 2]) * depth / K[1, 1]
    return np.sqrt(xs**2 + ys**2 + depth.astype(np.float64) ** 2)
