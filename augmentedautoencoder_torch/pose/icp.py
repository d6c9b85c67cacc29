"""Depth-based ICP pose refinement (port of augmentedautoencoder_tpu/pose/icp.py).

Algorithm parity with the JAX package, and through it with the reference
(auto_pose/eval/icp_utils.py, auto_pose/icp/icp.py): SVD-free best fit
with `depth_only` (translation-z only) and `no_depth` (x, y, R only) modes,
nearest-neighbour ICP with the JAX package's stopping rule, outlier
pre-gating by distance to the synthetic centroid, and the 20-degree
rotation-change rejection.

Device half (PyTorch, f32, batched over (n, ...) lanes): `best_fit_transform_torch`,
`_transform_pts`, `_converged` and the loop `icp_batch_torch`, whose
correspondence step is `ops.icp_nn.batched_nn` (the CUDA kernel on a GPU).
Every 3x3 product, the cross-covariance H and the point transform are
written as explicit f32 sums of elementwise products: no matmul, so no
TF32 on this path, and no torch.linalg (svd, inv, det). Every sum is a
fixed-order `tree_sum`, every mean multiplies it by the f32 reciprocal
of the count and every square root is the correctly rounded `sqrt_rn`
(ops/icp_nn.py), so the loop computes the same bits on the CPU and on the
GPU.

Host half (numpy, as in the JAX package): `SynRenderer`, the cloud prep
(`_real_cloud`, `_gate_dists_sq`, `_refinement_clouds`), `_apply_refinement`
and the 3-stage `ICP.refine` / `ICP.refine_batch`.

Device: `device=None` means the GPU (`factory.default_device`, which
raises without CUDA); pass device="cpu" to run the loop on the CPU.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..factory import default_device
from ..geometry.misc import rgbd_to_point_cloud
from ..geometry.transform import rotation_angle
from ..ops.icp_nn import batched_nn, sqrt_rn, sum3, tree_mean, tree_sum

Tensor = torch.Tensor

N_SUB = 3000  # reference subsample size (icp_utils.py:14)
ANGLE_CHANGE_LIMIT = 20.0 * np.pi / 180.0  # icp_utils.py:18

# The JAX package's fixed-point stopping rule for the f32 loop (its
# pose/icp.py:33-56): a lane stops when the reference's error-delta test
# fires, OR its correspondence indices stop changing, OR two consecutive
# refits moved the pose by less than both step tolerances.
STEP_TOL_ROT = 2e-4  # rad/iteration (~0.011 deg)
STEP_TOL_TRANS = 1e-2  # mm/iteration


def _cos_threshold(tol: float) -> float:
    """The largest f32 cosine whose angle is at least `tol`, so that for f32
    cosines, angle < tol <=> cosine > threshold (no arccos, whose rounding
    differs between devices)."""
    c = np.float32(np.cos(tol))
    while np.arccos(np.float64(c)) < tol:
        c = np.nextafter(c, np.float32(-1.0))
    return float(c)


_COS_STEP_TOL_ROT = _cos_threshold(STEP_TOL_ROT)

# The batched loop tests "every lane done" on the host only every this many
# iterations: frozen lanes do not change, so the results equal a test at
# every iteration while the host waits on the device 4x less often.
DONE_CHECK_EVERY = 4


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else default_device()


# ------------------------------------------------------------------ device half
def _mm3(A: Tensor, B: Tensor) -> Tensor:
    """(..., 3, 3) @ (..., 3, 3) as explicit f32 sums (no matmul, no TF32)."""
    return (
        A[..., :, 0, None] * B[..., None, 0, :]
        + A[..., :, 1, None] * B[..., None, 1, :]
        + A[..., :, 2, None] * B[..., None, 2, :]
    )


# The adjugate of a row-major 3x3 m0..m8, entry k = m[P]*m[Q] - m[R]*m[S]:
# the JAX package's cofactors, with -(x - y) written as y - x (equal in IEEE
# arithmetic), so one gather and three elementwise ops form all nine.
_ADJ_IDX = (
    (4, 2, 1, 5, 0, 2, 3, 1, 0),  # P
    (8, 7, 5, 6, 8, 3, 7, 6, 4),  # Q
    (5, 1, 2, 3, 2, 0, 4, 0, 1),  # R
    (7, 8, 4, 8, 6, 5, 6, 7, 3),  # S
)


@functools.lru_cache(maxsize=None)
def _adj_index(device: torch.device) -> Tensor:
    # one upload per device: a fresh host-to-device copy each call would
    # stall the ICP loop 16 times per iteration
    return torch.tensor(_ADJ_IDX, device=device).reshape(-1)


def _inv3(M: Tensor) -> Tensor:
    """Closed-form 3x3 inverse (adjugate / det) of (n, 3, 3), elementwise,
    det = (a A + b B) + c C as in the JAX package."""
    m = M.reshape(M.shape[0], 9)
    g = m[:, _adj_index(M.device)].reshape(-1, 4, 9)
    adj = g[:, 0] * g[:, 1] - g[:, 2] * g[:, 3]
    det = sum3(m[:, :3] * adj[:, ::3])
    return (adj / det[:, None]).reshape(-1, 3, 3)


def _det3(M: Tensor) -> Tensor:
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _kabsch_rotation(H: Tensor) -> Tensor:
    """Rotations maximising tr(R H) for (n, 3, 3) H, by the polar factor.

    H = U S V^T gives R = V U^T = polar_factor(H)^T, computed by 16 Newton
    steps X <- (X + X^-T) / 2 from a Frobenius-normalised start (the JAX
    package's method: products and 3x3 inverses only). Improper (det <= 0)
    or non-orthogonal (residual >= 1e-3) results are refused: identity.
    """
    X = H / sqrt_rn(tree_sum((H * H).flatten(-2), -1))[:, None, None]
    for _ in range(16):
        X = 0.5 * (X + _inv3(X).transpose(-1, -2))
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    resid = _mm3(X.transpose(-1, -2), X) - eye
    ortho_residual = sqrt_rn(tree_sum((resid * resid).flatten(-2), -1))
    proper = (_det3(X) > 0.0) & (ortho_residual < 1e-3)
    return torch.where(proper[:, None, None], X.transpose(-1, -2), eye)


def best_fit_transform_torch(A: Tensor, B: Tensor, depth_only: bool = False,
                             no_depth: bool = False) -> Tensor:
    """Least-squares rigid transforms mapping each lane of A (n, N, 3) onto
    B; returns (n, 4, 4).

    Conditioned as in the JAX package: the centroid difference is
    mean(B - A) (millimetre-scale differences, not ~700 mm coordinates), the
    centroid is anchored on the lane's first point, and the translation is
    d + (I - R) c_A, so the centroid's f32 error enters scaled by the
    rotation increment only.
    """
    n = A.shape[0]
    d = tree_mean(B - A, 1)
    T = torch.eye(4, dtype=A.dtype, device=A.device).repeat(n, 1, 1)
    if depth_only:
        T[:, 2, 3] = d[:, 2]
        return T
    anchor = A[:, :1]
    centroid_A = anchor[:, 0] + tree_mean(A - anchor, 1)
    centroid_B = centroid_A + d
    AA = A - centroid_A[:, None]
    BB = B - centroid_B[:, None]
    H = tree_sum(AA[..., :, None] * BB[..., None, :], 1)  # (n, 3, 3) = AA^T BB
    R = _kabsch_rotation(H)
    I_R = torch.eye(3, dtype=A.dtype, device=A.device) - R
    t = d + (
        I_R[..., 0] * centroid_A[:, 0, None]
        + I_R[..., 1] * centroid_A[:, 1, None]
        + I_R[..., 2] * centroid_A[:, 2, None]
    )
    if no_depth:  # t * (1, 1, 0), without uploading the mask (a sync on the GPU)
        t = torch.cat([t[:, :2], t[:, 2:] * 0.0], dim=1)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    return T


def _transform_pts(s: Tensor, T: Tensor) -> Tensor:
    """Apply (n, 4, 4) rigid transforms to (n, N, 3) clouds in full f32."""
    R = T[:, None, :3, :3]
    return (
        s[..., 0, None] * R[..., 0]
        + s[..., 1, None] * R[..., 1]
        + s[..., 2, None] * R[..., 2]
        + T[:, None, :3, 3]
    )


def _converged(prev_err, mean_err, tolerance, prev_idx, idx, Ts, prev_tiny):
    """Per-lane stopping rule. prev_err/mean_err (n,); prev_idx/idx (n, N);
    Ts (n, 4, 4); prev_tiny (n,) bool. Returns (done, tiny), tiny = this
    refit moved the pose by less than both step tolerances."""
    err_static = (prev_err - mean_err).abs() < tolerance
    idx_fixed = (idx == prev_idx).all(dim=-1)
    tr = Ts[:, 0, 0] + Ts[:, 1, 1] + Ts[:, 2, 2]
    cos_ang = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    tn = sqrt_rn(sum3(Ts[:, :3, 3] * Ts[:, :3, 3]))
    tiny = (cos_ang > _COS_STEP_TOL_ROT) & (tn < STEP_TOL_TRANS)
    return err_static | idx_fixed | (tiny & prev_tiny), tiny


def icp_batch_torch(A: Tensor, B: Tensor, max_iterations: int = 100, tolerance: float = 1e-6,
                    depth_only: bool = False, no_depth: bool = False):
    """Batched ICP over (n, N, 3) f32 clouds on their device.

    All lanes step through one loop of at most `max_iterations` global
    iterations; a lane that is done keeps its state frozen, so each lane's
    result equals its own sequential run. Returns (Ts (n, 4, 4), err (n,),
    iters (n,) int32) on the device.
    """
    n, N, _ = A.shape
    dev = A.device
    src = A
    prev = torch.zeros((n,), dtype=torch.float32, device=dev)
    err = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    iters = torch.zeros((n,), dtype=torch.int32, device=dev)
    prev_idx = torch.full((n, N), -1, dtype=torch.int32, device=dev)
    prev_tiny = torch.zeros((n,), dtype=torch.bool, device=dev)
    for g in range(max_iterations):
        if g % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        active = ~done
        dist, idx = batched_nn(src, B)
        Bsel = torch.gather(B, 1, idx.long()[..., None].expand(-1, -1, 3))
        Ts = best_fit_transform_torch(src, Bsel, depth_only=depth_only, no_depth=no_depth)
        src_new = _transform_pts(src, Ts)
        mean_err = tree_mean(dist, 1)
        newly_done, tiny = _converged(prev, mean_err, tolerance, prev_idx, idx, Ts, prev_tiny)
        src = torch.where(active[:, None, None], src_new, src)
        err = torch.where(active, mean_err, err)
        prev = torch.where(active, mean_err, prev)
        prev_idx = torch.where(active[:, None], idx, prev_idx)
        prev_tiny = torch.where(active, tiny, prev_tiny)
        iters = iters + active.to(torch.int32)
        done = done | (active & newly_done)
    Ts = best_fit_transform_torch(A, src, depth_only=depth_only, no_depth=no_depth)
    return Ts, err, iters


# ------------------------------------------------------------------ host API
def icp_batch(As, Bs, max_iterations: int = 100, tolerance: float = 1e-6,
              depth_only: bool = False, no_depth: bool = False, device=None):
    """Batched host-facing ICP: (n, N, 3) stacks -> [(T, err, iters)], one
    upload and one readback for the whole batch."""
    dev = _device(device)
    A = torch.as_tensor(np.asarray(As, np.float32)).to(dev)
    B = torch.as_tensor(np.asarray(Bs, np.float32)).to(dev)
    Ts, err, iters = icp_batch_torch(A, B, max_iterations, tolerance, depth_only, no_depth)
    Ts, err, iters = Ts.cpu().numpy(), err.cpu().numpy(), iters.cpu().numpy()
    return [(Ts[i], float(err[i]), int(iters[i])) for i in range(len(Ts))]


def icp(A, B, init_pose: Optional[np.ndarray] = None, max_iterations: int = 100,
        tolerance: float = 1e-6, depth_only: bool = False, no_depth: bool = False, device=None):
    """Single-lane host-facing ICP (the reference icp_utils.icp contract):
    (T (4, 4), mean error, iterations)."""
    A = np.asarray(A, np.float32)
    B = np.asarray(B, np.float32)
    if init_pose is not None:
        A = A @ init_pose[:3, :3].T + init_pose[:3, 3]
    return icp_batch(A[None], B[None], max_iterations, tolerance, depth_only, no_depth, device)[0]


def best_fit_transform(A, B, depth_only=False, no_depth=False, device=None):
    """Host-facing best fit (reference icp_utils.best_fit_transform): (T, R, t)."""
    dev = _device(device)
    T = best_fit_transform_torch(
        torch.as_tensor(np.asarray(A, np.float32))[None].to(dev),
        torch.as_tensor(np.asarray(B, np.float32))[None].to(dev),
        depth_only=depth_only, no_depth=no_depth,
    )[0].cpu().numpy()
    return T, T[:3, :3], T[:3, 3]


class SynRenderer:
    """Renders the estimated pose's depth for ICP (icp_utils.py:178-218).

    `renderer` is any object with the Renderer.render contract."""

    def __init__(self, renderer, clip_near: float = 10.0, clip_far: float = 10000.0):
        self.renderer = renderer
        self.clip_near = clip_near
        self.clip_far = clip_far

    def generate_synthetic_depth(self, K_test, R_est, t_est, test_shape, obj_id=0):
        """The reference geometry: render at [0, 0, tz] (centred), return the cloud."""
        W, H = test_shape[:2]
        _, depth = self.renderer.render(
            obj_id, W, H, K_test, R_est, np.array([0.0, 0.0, t_est[2]]),
            self.clip_near, self.clip_far, random_light=False,
        )
        return rgbd_to_point_cloud(K_test, depth)[0]

    def render_depth_window(self, K_test, R_est, t_est, window_shape, offset, obj_id=0):
        """Synthetic depth of only a crop window of the full frame: rendered
        at the window's size through a K whose principal point is shifted by
        the window origin, so pixel (u, v) here is pixel (u + left, v + top)
        of the full-frame render."""
        h, w = int(window_shape[0]), int(window_shape[1])
        left, top = (int(v) for v in offset)
        Kc = np.asarray(K_test, np.float64).copy()
        Kc[0, 2] -= left
        Kc[1, 2] -= top
        _, depth = self.renderer.render(
            obj_id, w, h, Kc, R_est, np.asarray(t_est),
            self.clip_near, self.clip_far, random_light=False,
        )
        return depth


def icp_refinement(depth_crop, icp_renderer: SynRenderer, R_est, t_est, K_test, test_render_dims,
                   depth_only: bool = False, no_depth: bool = False, max_mean_dist_factor: float = 2.0,
                   obj_id: int = 0, rng: Optional[np.random.RandomState] = None, device=None):
    """One refinement pass (reference icp_utils.icp_refinement:248-305)."""
    clouds = _refinement_clouds(
        depth_crop, icp_renderer, R_est, t_est, K_test, test_render_dims,
        max_mean_dist_factor=max_mean_dist_factor, obj_id=obj_id, rng=rng,
    )
    if clouds is None:
        return R_est, t_est
    A_sub, B_sub = clouds
    T, _, _ = icp(A_sub, B_sub, tolerance=1e-6, depth_only=depth_only, no_depth=no_depth, device=device)
    return _apply_refinement(T, R_est, t_est, no_depth=no_depth)


def _real_cloud(depth_crop, K_test, crop_offset=None):
    """The real depth crop's cloud (pose-independent, shared by both stages)
    as (pts (N, 3), |pts|^2 (N,)); K handling matches `_refinement_clouds`'
    two geometries."""
    K_crop = np.asarray(K_test, np.float64).copy()
    if crop_offset is not None:
        left, top = (int(v) for v in crop_offset)
        K_crop[0, 2] -= left
        K_crop[1, 2] -= top
    else:
        K_crop[0, 2] = depth_crop.shape[0] / 2
        K_crop[1, 2] = depth_crop.shape[1] / 2
    pts = rgbd_to_point_cloud(K_crop, depth_crop)[0]
    return pts, np.einsum("ij,ij->i", pts, pts)


def _gate_dists_sq(pts, pts_sq, centroid):
    """Squared distances ||p - c||^2 as |p|^2 - 2 p.c + |c|^2 (one matvec)."""
    return pts_sq - 2.0 * (pts @ centroid) + centroid @ centroid


def _refinement_clouds(depth_crop, icp_renderer, R_est, t_est, K_test, test_render_dims,
                       max_mean_dist_factor=2.0, obj_id=0, rng=None, crop_offset=None,
                       real_pts=None):
    """Host prep of one refinement: render, gate, subsample.

    Returns (A_sub (N_SUB, 3) synthetic, B_sub (N_SUB, 3) real), or None
    when the pass is gated out (object invisible or too little real depth).
    crop_offset=None is the reference's geometry (synthetic depth rendered
    centred at [0, 0, tz], the real crop re-projected through a
    crop-centred K); crop_offset=(left, top) renders only the crop's window
    at the estimated position, so both clouds live in the camera frame.
    real_pts: `_real_cloud`'s (pts, sq) pair, or None to project here.
    """
    rng = rng or np.random
    if crop_offset is not None:
        left, top = (int(v) for v in crop_offset)
        syn_crop = icp_renderer.render_depth_window(
            K_test, R_est, t_est, depth_crop.shape, (left, top), obj_id=obj_id,
        )
        K_crop = np.asarray(K_test, np.float64).copy()
        K_crop[0, 2] -= left
        K_crop[1, 2] -= top
        synthetic_pts = rgbd_to_point_cloud(K_crop, syn_crop)[0]
        if len(synthetic_pts) == 0:
            return None
        if real_pts is None:
            real_pts = _real_cloud(depth_crop, K_test, crop_offset=crop_offset)
    else:
        synthetic_pts = icp_renderer.generate_synthetic_depth(
            K_test, R_est, t_est, test_render_dims, obj_id=obj_id
        )
        if len(synthetic_pts) == 0:
            return None
        if real_pts is None:
            real_pts = _real_cloud(depth_crop, K_test, crop_offset=None)

    centroid_syn = np.einsum("ij->j", synthetic_pts) / len(synthetic_pts)
    syn_sq = np.einsum("ij,ij->i", synthetic_pts, synthetic_pts)
    max_mean_dist_sq = np.max(_gate_dists_sq(synthetic_pts, syn_sq, centroid_syn))
    rp, rp_sq = real_pts
    dist_sq_to_syn = _gate_dists_sq(rp, rp_sq, centroid_syn)
    gated = np.flatnonzero(dist_sq_to_syn < max_mean_dist_factor**2 * max_mean_dist_sq)

    if len(gated) < len(synthetic_pts) / 8.0:
        return None  # not enough visible points

    # N_SUB draws with replacement from each cloud, in the JAX package's
    # order (real, then synthetic), so a seeded RandomState draws the same
    sub_real = gated[rng.choice(len(gated), N_SUB)]
    sub_syn = rng.choice(len(synthetic_pts), N_SUB)
    return synthetic_pts[sub_syn], rp[sub_real]


def _apply_refinement(T, R_est, t_est, no_depth=False):
    """Compose a fitted T onto the estimate, with the reference's 20-degree
    rotation-change rejection on the no_depth stage."""
    if no_depth and abs(rotation_angle(T[:3, :3])) > ANGLE_CHANGE_LIMIT:
        T = np.eye(4)  # reject implausible rotation jumps

    H_est = np.eye(4)
    H_est[:3, :3] = R_est
    H_est[:3, 3] = t_est
    H_refined = T @ H_est
    return H_refined[:3, :3], H_refined[:3, 3]


class ICP:
    """Multi-object runtime ICP (reference auto_pose/icp/icp.py): tz-only
    ICP, x, y re-estimated at the corrected depth, then rotation-only ICP."""

    def __init__(self, renderers: dict, device=None):
        """renderers: class/object name -> SynRenderer; the loop runs on `device`."""
        self.renderers = renderers
        self.device = _device(device)

    def refine(self, depth_crop, R_est, t_est, K_test, test_render_dims, class_name=None,
               codebook=None, det_img=None, det_bb=None, train_cfg=None, upright: bool = False):
        syn = self.renderers[class_name] if class_name else next(iter(self.renderers.values()))
        # stage 1: depth-only alignment
        R1, t1 = icp_refinement(
            depth_crop, syn, R_est, t_est, K_test, test_render_dims, depth_only=True,
            device=self.device,
        )
        # stage 2: re-estimate x,y at the corrected depth
        if codebook is not None and det_img is not None:
            Rs, ts = codebook.auto_pose6d(
                det_img, det_bb, K_test, 1, train_cfg, depth_pred=t1[2], upright=upright,
            )
            R1, t1 = Rs[0], ts[0]
        # stage 3: rotation-only with angle-change rejection
        return icp_refinement(
            depth_crop, syn, R1, t1, K_test, test_render_dims, no_depth=True, device=self.device,
        )

    def refine_batch(self, depth_crops, Rs, ts, K_test, test_render_dims, class_name=None,
                     codebook=None, det_imgs=None, det_bbs=None, train_cfg=None,
                     upright: bool = False, rng=None, topk_aggregate: int = 1, tta: int = 1,
                     fixed_idcs=None, crop_offsets=None, stage2_candidates=None):
        """Batched 3-stage refinement of every estimate of a frame; returns
        (Rs (n, 3, 3), ts (n, 3)). Each ICP stage is one `icp_batch` over
        the detections that pass the gate.

        Stage 2 re-solves x, y at the stage-1 depths, from, in this order:
        `stage2_candidates` = (idcs (n, k), sims (n, k)) already queried
        (blended with `aggregate_candidates`; `upright` is not applied, as
        in the JAX package); `fixed_idcs` (n,) pinned codebook rows (after
        depth re-scoring); or a fresh query of `det_imgs` (detection-major,
        `tta` crops each) with `topk_aggregate`. `crop_offsets` (n, 2), each
        crop's (left, top) in the frame, selects the frame-accurate cloud
        geometry; None keeps the reference's centred one.
        """
        syn = self.renderers[class_name] if class_name else next(iter(self.renderers.values()))
        n = len(Rs)
        Rs = [np.asarray(R) for R in Rs]
        ts = [np.asarray(t) for t in ts]
        offsets = crop_offsets if crop_offsets is not None else [None] * n
        real_clouds = [_real_cloud(depth_crops[i], K_test, crop_offset=offsets[i]) for i in range(n)]

        def batched_stage(Rs_in, ts_in, depth_only, no_depth):
            preps = [
                _refinement_clouds(
                    depth_crops[i], syn, Rs_in[i], ts_in[i], K_test, test_render_dims,
                    rng=rng, crop_offset=offsets[i], real_pts=real_clouds[i],
                )
                for i in range(n)
            ]
            live = [i for i, p in enumerate(preps) if p is not None]
            Rs_out, ts_out = list(Rs_in), list(ts_in)
            if live:
                fits = icp_batch(
                    np.stack([preps[i][0] for i in live]), np.stack([preps[i][1] for i in live]),
                    tolerance=1e-6, depth_only=depth_only, no_depth=no_depth, device=self.device,
                )
                for (T, _, _), i in zip(fits, live):
                    Rs_out[i], ts_out[i] = _apply_refinement(T, Rs_in[i], ts_in[i], no_depth=no_depth)
            return Rs_out, ts_out

        # stage 1: depth-only alignment
        R1s, t1s = batched_stage(Rs, ts, depth_only=True, no_depth=False)
        # stage 2: re-estimate x,y at the corrected depths
        if stage2_candidates is not None and codebook is not None:
            from ..codebook import aggregate_candidates

            idcs_k, sims_k = stage2_candidates
            depth_pred = np.array([t[2] for t in t1s])
            R0, rendered_bbs, _ = aggregate_candidates(
                codebook.viewsphere, codebook.embed_obj_bbs, np.asarray(idcs_k), np.asarray(sims_k),
            )
            R2s, t2s = codebook._solve_6d(
                R0, rendered_bbs, np.stack(det_bbs), K_test, train_cfg, depth_pred=depth_pred,
            )
            R1s, t1s = list(R2s), list(t2s)
        elif fixed_idcs is not None and codebook is not None:
            depth_pred = np.array([t[2] for t in t1s])
            R2s, t2s = codebook.pose6d_from_indices(
                np.asarray(fixed_idcs), np.stack(det_bbs), K_test, train_cfg, depth_pred=depth_pred,
            )
            R1s, t1s = list(R2s), list(t2s)
        elif codebook is not None and det_imgs is not None:
            depth_pred = np.array([t[2] for t in t1s])
            R2s, t2s, _ = codebook.auto_pose6d_batch(
                np.stack(det_imgs), np.stack(det_bbs), K_test, train_cfg, depth_pred=depth_pred,
                upright=upright, topk_aggregate=topk_aggregate, tta=tta,
            )
            R1s, t1s = list(R2s), list(t2s)
        # stage 3: rotation-only with angle-change rejection
        R3s, t3s = batched_stage(R1s, t1s, depth_only=False, no_depth=True)
        return np.stack(R3s), np.stack(t3s)
