"""AePoseEstimator: multi-object 6D pose from detections + codebooks
(port of augmentedautoencoder_tpu/pose/estimator.py).

A test config maps class names to per-object experiments; `process(bboxes,
color_img, camK)` returns 4x4 `PoseEstimate`s in meters (mm with mm=True),
optionally transformed by camPose. Detections are grouped by class, and
each class's crops run through one batched encode and one codebook query.

With a depth image (in the meshes' units, mm), `topk_rescore > 1` expands
the top-k matches into 6D hypotheses and keeps the one whose rendered
depth best explains the frame (pose/rescore.py), and `use_icp` refines
every pose with the 3-stage ICP (pose/icp.py; `icp_frame_accurate` for the
frame-accurate cloud geometry). Both render each class's `MODEL_PATH` mesh
with the host C++ rasterizer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import factory
from ..cli import split_experiment_name
from ..config import safe_eval
from ..codebook import tta_jittered_bboxes
from .interfaces import BoundingBox, PoseEstimate, PoseEstInterface, Roi3D
from .rescore import select_best_hypothesis

_COEF_BITS = 11  # cv::resize INTER_LINEAR 8u: 11-bit fixed-point weights
_COEF_ONE = 1 << _COEF_BITS


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """Source taps and fixed-point weights of cv::resize INTER_LINEAR along
    one axis: f = (d + 0.5) * scale - 0.5 in float32, weights rounded to
    11 bits. Columns clamp (index, weight) at the edges; rows keep the
    fractional weight and clamp only the row index, as OpenCV does."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0
        s = np.clip(s, 0, src - 1)
    w1 = np.rint(f * np.float32(_COEF_ONE)).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_ONE)).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR)` for an
    (H, W, C) uint8 image, bit for bit: OpenCV's fixed-point horizontal
    pass, its vectorised vertical rounding, and its switch to INTER_AREA
    for an exact 2x downscale."""
    dw, dh = dsize
    sh, sw = img.shape[:2]
    if (sw, sh) == (dw, dh):
        return img.copy()
    if sw == 2 * dw and sh == 2 * dh:
        a = img.astype(np.int32)
        out = (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2] + 2) >> 2
        return out.astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(sw, dw, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(sh, dh, clamp_weights=False)

    def horizontal(rows):  # (n, sw, C) uint8 -> (n, dw, C), 11-bit weights
        r = rows.astype(np.int32)
        return r[:, x0] * a0[None, :, None] + r[:, x1] * a1[None, :, None]

    # only the 2 * dh source rows the vertical pass reads; int32 holds
    # 255 * 2048 * 2048 >> 4 without overflow
    t0 = ((horizontal(img[y0]) >> 4) * b0[:, None, None]) >> 16
    t1 = ((horizontal(img[y1]) >> 4) * b1[:, None, None]) >> 16
    return np.clip((t0 + t1 + 2) >> 2, 0, 255).astype(np.uint8)


def extract_square_patch_centered(
    scene_img: np.ndarray,
    bb_xywh,
    pad_factor: float,
    resize=(128, 128),
    interpolation: str = "linear",
    black_borders: bool = False,
) -> np.ndarray:
    """Square patch on a black size x size canvas, bbox centered, resized
    to `resize` (w, h). Off-image regions and, with black_borders, pixels
    outside the detected box are zero. Needs no OpenCV; only the
    "linear" interpolation that inference uses is supported."""
    if interpolation != "linear":
        raise ValueError(f"only interpolation='linear' is supported, got {interpolation!r}")
    x, y, w, h = np.array(bb_xywh).astype(np.int32)
    size = int(np.maximum(h, w) * pad_factor)

    scene_crop = np.zeros((size, size, 3), dtype=np.uint8)
    if black_borders:
        scene_crop[
            (size - h) // 2 : (size - h) // 2 + h,
            (size - w) // 2 : (size - w) // 2 + w,
        ] = scene_img[y : y + h, x : x + w].copy()
    else:
        left = int(np.maximum(x + w / 2 - size / 2, 0))
        right = int(np.minimum(x + w / 2 + size / 2, scene_img.shape[1]))
        top = int(np.maximum(y + h / 2 - size / 2, 0))
        bottom = int(np.minimum(y + h / 2 + size / 2, scene_img.shape[0]))
        size_h, size_w = bottom - top, right - left
        scene_crop[
            (size - size_h) // 2 : (size - size_h) // 2 + size_h,
            (size - size_w) // 2 : (size - size_w) // 2 + size_w,
        ] = scene_img[top:bottom, left:right].copy()

    return resize_linear_u8(scene_crop, tuple(resize))


def depth_crops_of(depth_img: np.ndarray, box_xywhs, pad_factor: float, frame_hw):
    """Square bbox-centred, un-resized depth crops (the geometry ICP's K
    re-centring assumes), clipped to the (H, W) frame, and each crop's
    (left, top)."""
    H, W = frame_hw
    crops, offsets = [], []
    for xywh in box_xywhs:
        x, y, w, h = (int(v) for v in xywh)
        size = int(max(h, w) * pad_factor)
        left = max(int(x + w / 2 - size / 2), 0)
        right = min(int(x + w / 2 + size / 2), W)
        top = max(int(y + h / 2 - size / 2), 0)
        bottom = min(int(y + h / 2 + size / 2), H)
        crops.append(depth_img[top:bottom, left:right])
        offsets.append((left, top))
    return crops, offsets


class AePoseEstimator(PoseEstInterface):
    """Many per-object codebooks behind one `process` call, on `device`
    (default: the GPU; without CUDA pass device="cpu")."""

    def __init__(self, test_config_path, device=None):
        test_args = self.get_params(test_config_path)
        self.test_args = test_args  # serving layers read extra options
        self.device = torch.device(device) if device is not None else factory.default_device()

        self._camPose = test_args.getboolean("auto_pose", "camPose")
        self._upright = test_args.getboolean("auto_pose", "upright")
        self._topk = test_args.getint("auto_pose", "topk")
        if self._topk > 1:
            raise NotImplementedError("topk > 1 not implemented")
        self._topk_aggregate = test_args.getint("auto_pose", "topk_aggregate", fallback=1)
        self._tta_crops = test_args.getint("auto_pose", "tta_crops", fallback=1)
        self._topk_rescore = test_args.getint("auto_pose", "topk_rescore", fallback=1)
        self._rescore_tau = test_args.getfloat("auto_pose", "rescore_tau", fallback=20.0)
        if self._topk_rescore > 1 and self._topk_aggregate > 1:
            raise ValueError(
                "topk_rescore and topk_aggregate are mutually exclusive: "
                "re-scoring picks one hypothesis, aggregation blends several"
            )
        self._use_icp = test_args.getboolean("auto_pose", "use_icp", fallback=False)
        self._icp_frame_accurate = test_args.getboolean(
            "auto_pose", "icp_frame_accurate", fallback=False
        )
        self._icp = None

        self._process_requirements = ["color_img", "camK", "bboxes"]
        if self._use_icp or self._topk_rescore > 1:
            self._process_requirements.append("depth_img")
        if self._camPose:
            self._process_requirements.append("camPose")

        _dtypes = {"np.float32": np.float32, "np.float64": np.float64, "np.uint8": np.uint8}
        self._image_format = {
            "color_format": test_args.get("auto_pose", "color_format"),
            "color_data_type": _dtypes.get(
                test_args.get("auto_pose", "color_data_type"), np.float32
            ),
            "depth_data_type": _dtypes.get(
                test_args.get("auto_pose", "depth_data_type"), np.float32
            ),
        }

        self.class_2_encoder = safe_eval(test_args.get("auto_pose", "class_2_encoder"))

        self.all_codebooks: Dict = {}
        self.all_train_cfgs: Dict = {}
        self.pad_factors: Dict = {}
        self.patch_sizes: Dict = {}

        for class_name, experiment in self.class_2_encoder.items():
            experiment_name, experiment_group = split_experiment_name(experiment)
            cfg, _ = factory.load_experiment_config(experiment_name, experiment_group)
            self.all_train_cfgs[class_name] = cfg
            self.pad_factors[class_name] = cfg.pad_factor
            self.patch_sizes[class_name] = (cfg.w, cfg.h)
            self.all_codebooks[class_name] = factory.build_codebook_from_name(
                experiment_name, experiment_group, device=self.device
            )

    def _icp_handle(self):
        """Lazy per-class ICP: each class's mesh in the native rasterizer
        (a failed build raises), the loop on this estimator's device."""
        if self._icp is None:
            from ..renderer import Renderer
            from ..renderer.mesh import load_mesh
            from .icp import ICP, SynRenderer

            renderers = {}
            for class_name, cfg in self.all_train_cfgs.items():
                mesh = load_mesh(cfg.model_path, vertex_scale=cfg.vertex_scale)
                renderers[class_name] = SynRenderer(Renderer([], backend="native", meshes=[mesh]))
            self._icp = ICP(renderers, device=self.device)
        return self._icp

    # ------------------------------------------------------------- contract
    def set_parameter(self, string_name: str, string_val: str) -> None:
        pass

    def query_process_requirements(self) -> List[str]:
        return self._process_requirements

    def query_image_format(self) -> Dict:
        return self._image_format

    # ------------------------------------------------------------- process
    def process(
        self,
        bboxes: Sequence[BoundingBox] = (),
        color_img: Optional[np.ndarray] = None,
        depth_img: Optional[np.ndarray] = None,
        camK: Optional[np.ndarray] = None,
        camPose: Optional[np.ndarray] = None,
        rois3ds: Sequence[Roi3D] = (),
        mm: bool = False,
    ) -> List[PoseEstimate]:
        H, W = color_img.shape[:2]

        by_class: Dict[str, List[int]] = {}
        box_xywhs: List[Optional[List[float]]] = []
        for j, box in enumerate(bboxes):
            pred_class = box.best_class
            if pred_class not in self.class_2_encoder:
                print(f"{pred_class} not in configured classes {list(self.class_2_encoder)}")
                box_xywhs.append(None)
                continue
            xywh = box.to_xywh(W, H)
            if np.any(np.array(xywh) < 0):
                print(f"invalid bb {xywh}")
                box_xywhs.append(None)
                continue
            box_xywhs.append(xywh)
            by_class.setdefault(pred_class, []).append(j)

        results: List[Optional[PoseEstimate]] = [None] * len(bboxes)
        tta = max(self._tta_crops, 1)
        for class_name, det_idcs in by_class.items():
            cfg = self.all_train_cfgs[class_name]
            crops = np.stack(
                [
                    extract_square_patch_centered(
                        color_img,
                        jbb,
                        self.pad_factors[class_name],
                        resize=self.patch_sizes[class_name],
                        interpolation="linear",
                        black_borders=True,
                    )
                    for j in det_idcs
                    for jbb in (
                        tta_jittered_bboxes(box_xywhs[j], tta)
                        if tta > 1
                        else [box_xywhs[j]]
                    )
                ]
            )
            bbs = np.stack([box_xywhs[j] for j in det_idcs])
            codebook = self.all_codebooks[class_name]
            sel_idcs = None
            if self._topk_rescore > 1 and depth_img is not None:
                idcs_k, _ = codebook.topk_candidates(
                    crops, self._topk_rescore, upright=self._upright, tta=tta
                )
                B, k = idcs_k.shape
                Rs_f, ts_f = codebook.pose6d_from_indices(idcs_k, bbs, camK, cfg)
                best, _ = select_best_hypothesis(
                    self._icp_handle().renderers[class_name].renderer,
                    camK, (W, H), depth_img,
                    Rs_f.reshape(B, k, 3, 3), ts_f.reshape(B, k, 3),
                    tau=self._rescore_tau,
                )
                rows = np.arange(B)
                Rs = Rs_f.reshape(B, k, 3, 3)[rows, best]
                ts = ts_f.reshape(B, k, 3)[rows, best]
                sel_idcs = idcs_k[rows, best]
            else:
                Rs, ts, _ = codebook.auto_pose6d_batch(
                    crops, bbs, camK, cfg, upright=self._upright,
                    topk_aggregate=self._topk_aggregate, tta=tta,
                )
            if self._use_icp and depth_img is not None:
                depth_crops, crop_offsets = depth_crops_of(
                    depth_img, [box_xywhs[j] for j in det_idcs], self.pad_factors[class_name], (H, W)
                )
                Rs, ts = self._icp_handle().refine_batch(
                    depth_crops, Rs, ts, camK, (W, H), class_name=class_name,
                    codebook=codebook,
                    det_imgs=crops,  # the full (B*tta) detection-major stack
                    det_bbs=bbs, train_cfg=cfg, upright=self._upright,
                    topk_aggregate=self._topk_aggregate, tta=tta,
                    fixed_idcs=sel_idcs,
                    crop_offsets=crop_offsets if self._icp_frame_accurate else None,
                )
            for k, j in enumerate(det_idcs):
                H_est = np.eye(4)
                H_est[:3, :3] = Rs[k]
                H_est[:3, 3] = ts[k] if mm else ts[k] / 1000.0
                if self._camPose:
                    H_est = camPose @ H_est
                results[j] = PoseEstimate(name=bboxes[j].best_class, trafo=H_est)

        return [r for r in results if r is not None]
