"""Depth-based re-scoring of top-k pose hypotheses (copy of
augmentedautoencoder_tpu/pose/rescore.py).

New capability vs the reference, which always commits to the single cosine
argmax (reference codebook.py:64-71) and can only *refine* it with ICP. With
a depth image available, the k best codebook matches are instead EXPANDED
into full 6D hypotheses (codebook.pose6d_from_indices) and each is scored
against the observed depth — one host-rasterizer render per hypothesis —
keeping the hypothesis whose rendered depth best explains the scene. Unlike
ICP (a local optimization inside the argmax basin) this corrects
wrong-basin matches caused by clutter/occlusion, and unlike topk_aggregate
(a blend of neighboring bins) it can jump to a non-adjacent mode.

Score: VSD-style inlier fraction with the step cost (evaluation/
pose_errors.py semantics, VSD_TAU default 20 mm) restricted to the
hypothesis's own rendered footprint — occluding foreground pixels count as
mismatches for every hypothesis equally, so visibility bias cancels in the
argmax. Cost: B*k host renders per frame; at the eval operating point
(360x270, ~24 hypotheses/frame) this is a few ms/frame on the SIMD
rasterizer (PERF.md round-3 rasterizer section).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def depth_hypothesis_scores(
    renderer,
    K_test: np.ndarray,
    test_shape,
    depth_img: np.ndarray,
    Rs: np.ndarray,
    ts: np.ndarray,
    tau: float = 20.0,
    clip_near: float = 10.0,
    clip_far: float = 10000.0,
    obj_id: int = 0,
) -> np.ndarray:
    """Inlier-fraction depth score for each (R, t) hypothesis.

    renderer follows the Renderer.render contract (same object the ICP
    SynRenderer wraps). Returns scores (n,) in [0, 1]; an off-screen
    hypothesis scores -1 so it can never win over a visible one.
    """
    W, H = test_shape[:2]
    depth_img = np.asarray(depth_img)
    scores = np.empty(len(Rs), dtype=np.float64)
    for j in range(len(Rs)):
        _, d_ren = renderer.render(
            obj_id, W, H, K_test, np.asarray(Rs[j]), np.asarray(ts[j]),
            clip_near, clip_far, random_light=False,
        )
        footprint = d_ren > 0
        n_vis = int(footprint.sum())
        if n_vis == 0:
            scores[j] = -1.0
            continue
        inlier = footprint & (depth_img > 0) & (np.abs(depth_img - d_ren) < tau)
        scores[j] = inlier.sum() / n_vis
    return scores


def select_best_hypothesis(
    renderer,
    K_test: np.ndarray,
    test_shape,
    depth_img: np.ndarray,
    Rs_k: np.ndarray,
    ts_k: np.ndarray,
    tau: float = 20.0,
    clip_near: float = 10.0,
    clip_far: float = 10000.0,
    obj_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pick the best-scoring hypothesis per detection.

    Rs_k (B,k,3,3), ts_k (B,k,3) -> (best (B,) column indices,
    scores (B,k)). Ties resolve to the LOWEST column index, i.e. the
    higher-cosine candidate, so k=1 or an all-tied row degrades exactly to
    the argmax behavior.
    """
    Rs_k = np.asarray(Rs_k)
    ts_k = np.asarray(ts_k)
    B, k = Rs_k.shape[:2]
    scores = depth_hypothesis_scores(
        renderer, K_test, test_shape, depth_img,
        Rs_k.reshape(B * k, 3, 3), ts_k.reshape(B * k, 3),
        tau=tau, clip_near=clip_near, clip_far=clip_far, obj_id=obj_id,
    ).reshape(B, k)
    return np.argmax(scores, axis=1), scores
