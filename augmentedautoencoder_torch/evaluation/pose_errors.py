"""6D pose error metrics (Hodan et al.'s sixd/BOP definitions; port of
augmentedautoencoder_tpu/evaluation/pose_errors.py).

The reference delegates these to the external sixd_toolkit
(sixd_toolkit_extensions/eval_calc_errors.py parameterizes them); here they
are implemented natively. `add`, `re`, `te`, `proj`, `cou_mask` and `vsd`
are numpy, as in the JAX package; `vsd` renders est/gt depth with the
port's rasterizer. `adi`'s nearest-neighbour term is the ICP kernel
(`ops.icp_nn.batched_nn`: csrc/icp_nn.cu on a CUDA device, its plain
version on the CPU), one lane per (estimate, GT) pair; `adi_many` scores
many pairs in one call.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry.misc import depth_im_to_dist_im, project_pts
from ..geometry.transform import rotation_error
from ..ops.icp_nn import batched_nn


def _transform_pts(pts: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return pts @ np.asarray(R).T + np.asarray(t).reshape(1, 3)


def add(R_est, t_est, R_gt, t_gt, pts: np.ndarray) -> float:
    """Average distance of model points (non-symmetric objects)."""
    a = _transform_pts(pts, R_est, t_est)
    b = _transform_pts(pts, R_gt, t_gt)
    return float(np.linalg.norm(a - b, axis=1).mean())


def adi_many(pairs: Sequence[Tuple], pts: np.ndarray, device=None) -> list:
    """`adi` of each (R_est, t_est, R_gt, t_gt) pair: one B4 call on
    `device` (default: the GPU, `factory.default_device`) with one lane per
    pair (src = the points at the GT pose, dst = at the estimate), one
    readback. The mean of each lane's distances is numpy's f32 mean, as the
    JAX package takes it."""
    if not pairs:
        return []
    from ..factory import default_device  # factory imports the model stack

    dev = torch.device(device) if device is not None else default_device()
    a = np.stack([_transform_pts(pts, Re, te_) for Re, te_, _, _ in pairs]).astype(np.float32)
    b = np.stack([_transform_pts(pts, Rg, tg) for _, _, Rg, tg in pairs]).astype(np.float32)
    dist, _ = batched_nn(torch.from_numpy(b).to(dev), torch.from_numpy(a).to(dev))
    dist = dist.cpu().numpy()
    return [float(d.mean()) for d in dist]


def adi(R_est, t_est, R_gt, t_gt, pts: np.ndarray, device=None) -> float:
    """Average nearest-point distance (symmetric objects)."""
    return adi_many([(R_est, t_est, R_gt, t_gt)], pts, device)[0]


def re(R_est, R_gt) -> float:
    """Rotation error in degrees."""
    return float(np.rad2deg(rotation_error(R_gt, R_est)))


def te(t_est, t_gt) -> float:
    """Translation error (euclidean, model units)."""
    return float(np.linalg.norm(np.asarray(t_est).ravel() - np.asarray(t_gt).ravel()))


def proj(R_est, t_est, R_gt, t_gt, K, pts: np.ndarray) -> float:
    """Mean 2D projection distance in pixels."""
    a = project_pts(pts, K, np.asarray(R_est), np.asarray(t_est))
    b = project_pts(pts, K, np.asarray(R_gt), np.asarray(t_gt))
    return float(np.linalg.norm(a - b, axis=1).mean())


def cou_mask(mask_est: np.ndarray, mask_gt: np.ndarray) -> float:
    """Complement over union of binary masks."""
    union = np.logical_or(mask_est, mask_gt).sum()
    if union == 0:
        return 0.0
    inter = np.logical_and(mask_est, mask_gt).sum()
    return 1.0 - inter / union


def _render_depth(renderer, K, R, t, W, H, obj_id=0):
    _, depth = renderer.render(
        obj_id, W, H, np.asarray(K, np.float64), R, np.asarray(t).ravel(),
        10.0, 10000.0, random_light=False,
    )
    return depth


def estimate_visibility_mask(
    d_test: np.ndarray, d_model: np.ndarray, delta: float
) -> np.ndarray:
    """Pixels of the model render visible in the test image: rendered depth
    within delta in front of (or at) the measured depth, or measured depth
    missing (sixd_toolkit visibility convention)."""
    mask = d_model > 0
    known = d_test > 0
    visib = mask & (~known | (d_model - d_test <= delta))
    return visib


def vsd(
    R_est,
    t_est,
    R_gt,
    t_gt,
    depth_test: np.ndarray,
    K: np.ndarray,
    renderer,
    delta: float = 15.0,
    tau: float = 20.0,
    cost: str = "step",
    obj_id: int = 0,
) -> float:
    """Visible Surface Discrepancy (Hodan ECCV'16; eval_template.cfg:22-28
    defaults delta=15, tau=20, step cost).

    Renders est and gt depth at full image size, derives visibility masks
    w.r.t. the measured test depth, and averages the per-pixel cost of the
    distance difference over the union of visible surfaces.
    """
    H, W = depth_test.shape
    d_est = _render_depth(renderer, K, R_est, t_est, W, H, obj_id)
    d_gt = _render_depth(renderer, K, R_gt, t_gt, W, H, obj_id)

    # convert z-depths to ray distances (sixd uses dist images for vsd)
    dist_test = depth_im_to_dist_im(depth_test, K)
    dist_est = depth_im_to_dist_im(d_est, K)
    dist_gt = depth_im_to_dist_im(d_gt, K)
    dist_test[depth_test == 0] = 0
    dist_est[d_est == 0] = 0
    dist_gt[d_gt == 0] = 0

    visib_gt = estimate_visibility_mask(dist_test, dist_gt, delta)
    # est visibility additionally includes pixels where the estimate falls
    # behind the gt surface region (standard vsd est-visibility extension)
    visib_est = estimate_visibility_mask(dist_test, dist_est, delta)
    visib_est = visib_est | (visib_gt & (dist_est > 0))

    visib_union = visib_gt | visib_est
    visib_inter = visib_gt & visib_est
    n_union = int(visib_union.sum())
    if n_union == 0:
        return 1.0

    d_diff = np.abs(dist_gt[visib_inter] - dist_est[visib_inter])
    if cost == "step":
        costs = (d_diff >= tau).astype(np.float64)
    elif cost == "tlinear":
        costs = np.minimum(d_diff / tau, 1.0)
    else:
        raise ValueError(f"unknown vsd cost: {cost}")

    # non-overlapping visible pixels cost 1
    e = (costs.sum() + (n_union - int(visib_inter.sum()))) / n_union
    return float(e)


def calc_error(
    error_type: str,
    R_est,
    t_est,
    R_gt,
    t_gt,
    *,
    pts: Optional[np.ndarray] = None,
    K: Optional[np.ndarray] = None,
    depth_test: Optional[np.ndarray] = None,
    renderer=None,
    vsd_delta: float = 15.0,
    vsd_tau: float = 20.0,
    vsd_cost: str = "step",
    obj_id: int = 0,
    device=None,
) -> float:
    """Dispatch like the reference eval_calc_errors (parameterized by cfg);
    `adi` runs on `device`."""
    if error_type == "add":
        return add(R_est, t_est, R_gt, t_gt, pts)
    if error_type == "adi":
        return adi(R_est, t_est, R_gt, t_gt, pts, device)
    if error_type == "re":
        return re(R_est, R_gt)
    if error_type == "te":
        return te(t_est, t_gt)
    if error_type == "proj":
        return proj(R_est, t_est, R_gt, t_gt, K, pts)
    if error_type == "vsd":
        return vsd(
            R_est, t_est, R_gt, t_gt, depth_test, K, renderer,
            delta=vsd_delta, tau=vsd_tau, cost=vsd_cost, obj_id=obj_id,
        )
    raise ValueError(f"unknown error type: {error_type}")
