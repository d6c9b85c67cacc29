"""Batched multi-object pose serving (port of augmentedautoencoder_tpu/serving.py).

  * Every class's encoder stays resident on the device; a frame runs one
    encode per PRESENT class, in fixed `max_dets_per_class` chunks, so the
    work per frame is O(present classes), and crowded classes run several
    chunks instead of dropping detections.
  * All codebooks live in one (O, N_pad, D) slab with true lengths; each
    present class queries its own plane through the CUDA kernels:
    `grouped_codebook_top1` for k = 1, `grouped_codebook_topk` for the
    `topk_aggregate` / `topk_rescore` candidates (k <= 32) and for the
    `upright` top-1 (k = 1 with the num_cyclo stride). On CPU tensors the
    same calls run their plain versions. The slab is stored with zero
    columns up to the width the kernels take (`pad_slab`), so any latent
    width serves.
  * `submit()` enqueues the device work and a non-blocking copy of the
    (B[, k]) results into pinned host memory, and records a CUDA event;
    `retrieve()` waits on that event and finishes the pose math on the
    host. `process_stream` runs retrieve on one worker thread, so frame n's
    pose math overlaps frame n+1's crops and dispatch, results in order.

bf16 precision runs the convs in bf16 with the f32 latent head, stores the
slab in bf16 and accumulates the cosines in f32.

With a depth image, retrieve() also runs the depth stages of the test
config: `topk_rescore` picks among the submit-time top-k by rendered depth
(pose/rescore.py), and `use_icp` refines each class's poses with one
batched 3-stage ICP (pose/icp.py; the correspondence step is the CUDA
kernel csrc/icp_nn.cu). ICP's stage 2 re-uses the submit-time candidates
instead of encoding the crops again. Under `profile=True` that stage is
timed as `icp`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from . import factory
from .cli import split_experiment_name
from .codebook import aggregate_candidates
from .ops.multi_codebook import (
    grouped_codebook_top1,
    grouped_codebook_topk,
    grouped_codebook_topk_plain,
    pad_slab,
    stack_codebooks,
)
from .pose.estimator import AePoseEstimator, depth_crops_of, extract_square_patch_centered
from .pose.interfaces import BoundingBox, PoseEstimate
from .pose.rescore import select_best_hypothesis

_SLAB_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def _noop_stage(_name):
    yield


@dataclasses.dataclass
class _FrameHandle:
    vals: Dict[str, List[torch.Tensor]]  # per present class: (max_dets, k) host tensors (k > 1 only)
    idcs: Dict[str, List[torch.Tensor]]  # per present class: (max_dets[, k]) host tensors
    ready: Optional[torch.cuda.Event]  # recorded after the D2H copies (None on CPU)
    by_class: Dict[str, List[int]]
    box_xywhs: List[Optional[List[float]]]
    bboxes: Sequence[BoundingBox]
    camK: np.ndarray
    camPose: Optional[np.ndarray]
    mm: bool
    depth_img: Optional[np.ndarray]  # kept only when a depth stage will read it


class PoseServer:
    """Multi-class 6D pose serving: resident per-class encoders + one
    codebook slab on `device`, dispatching only for classes present in each
    frame. All classes must share one network architecture."""

    def __init__(
        self,
        test_config_path: str,
        max_dets_per_class: int = 8,
        precision: Optional[str] = None,
        profile: bool = False,
        device=None,
    ):
        self._est = AePoseEstimator(test_config_path, device=device)
        self.device = self._est.device
        self.max_dets = int(max_dets_per_class)
        # optional wall-clock stage split, accumulated across frames; with
        # submit/retrieve pipelining, stages of different frames overlap
        self.profile = bool(profile)
        self.profile_times: Dict[str, float] = {}
        self.profile_frames = 0
        if precision is None:
            precision = self._est.test_args.get(
                "auto_pose", "serving_precision", fallback="float32"
            )
        if precision not in _SLAB_DTYPES:
            raise ValueError(f"unknown serving precision: {precision!r}")
        self.precision = precision

        self.classes = sorted(self._est.class_2_encoder)
        cfgs = [self._est.all_train_cfgs[c] for c in self.classes]
        arch = {
            (c.h, c.w, c.c, c.latent_space_size, tuple(c.num_filter), tuple(c.strides))
            for c in cfgs
        }
        if len(arch) != 1:
            raise ValueError(
                "PoseServer needs one shared architecture across classes; "
                f"got {arch}. Use AePoseEstimator for heterogeneous setups."
            )
        self.cfg0 = cfgs[0]

        self._models = {}
        codebooks = []
        for c in self.classes:
            name, group = split_experiment_name(self._est.class_2_encoder[c])
            _, _, model, _ = factory.restore_experiment(
                name, group, device=self.device, precision=self.precision
            )
            self._models[c] = model
            codebooks.append(self._est.all_codebooks[c].embedding_normalized.cpu().numpy())
        slab, lengths = stack_codebooks(codebooks)
        # one device copy, with zero columns up to the kernels' width
        self._slab = pad_slab(torch.as_tensor(slab).to(_SLAB_DTYPES[self.precision])).to(self.device)
        self._lengths = [int(n) for n in lengths]

        self._query_k = max(self._est._topk_aggregate, self._est._topk_rescore, 1)
        self._oi_by_class = {c: i for i, c in enumerate(self.classes)}
        self._stride_by_class = {
            c: int(self._est.all_codebooks[c].num_cyclo) if self._est._upright else 1
            for c in self.classes
        }
        # per-class k, clamped to the class's candidate count (the strided
        # width under `upright`), as Codebook._clamp_k does: a larger k
        # would return masked pad rows that index past the viewsphere
        self._k_by_class = {}
        for c, n_valid in zip(self.classes, self._lengths):
            stride = self._stride_by_class[c]
            width = n_valid if stride <= 1 else -(-n_valid // stride)
            self._k_by_class[c] = min(self._query_k, width)

    # ------------------------------------------------------------- profiling
    def _stage_timer(self):
        """Stage-accumulating context factory; a shared no-op when off."""
        if not self.profile:
            return _noop_stage

        @contextlib.contextmanager
        def stage(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.profile_times[name] = (
                    self.profile_times.get(name, 0.0) + time.perf_counter() - t0
                )

        return stage

    def profile_summary(self) -> Dict[str, float]:
        """Mean per-frame milliseconds per stage (profile=True only)."""
        n = max(self.profile_frames, 1)
        return {k: 1e3 * v / n for k, v in sorted(self.profile_times.items())}

    def _query(self, z: torch.Tensor, oi: int):
        """This class's codebook matches: (vals (B, k), idcs (B, k)) for
        k > 1, else (vals (B,), idcs (B,))."""
        cls = self.classes[oi]
        stride = self._stride_by_class[cls]
        n_valid = self._lengths[oi]
        if self._query_k > 1:
            k = self._k_by_class[cls]
            if k <= 32:
                return grouped_codebook_topk(z, self._slab, oi, n_valid, k=k, stride=stride)
            # the kernel takes k <= 32; larger k ranks with the plain version
            return grouped_codebook_topk_plain(z, self._slab, oi, n_valid, k=k, stride=stride)
        if stride > 1:
            v, i = grouped_codebook_topk(z, self._slab, oi, n_valid, k=1, stride=stride)
            return v[:, 0], i[:, 0]
        return grouped_codebook_top1(z, self._slab, oi, n_valid)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    # ---------------------------------------------------------------- submit
    @torch.inference_mode()
    def submit(
        self,
        bboxes: Sequence[BoundingBox],
        color_img: np.ndarray,
        camK: np.ndarray,
        camPose: Optional[np.ndarray] = None,
        mm: bool = False,
        depth_img: Optional[np.ndarray] = None,
    ) -> _FrameHandle:
        """Crop + dispatch one frame; returns a handle without waiting for
        the device."""
        H, W = color_img.shape[:2]
        by_class: Dict[str, List[int]] = {}
        box_xywhs: List[Optional[List[float]]] = []
        for j, box in enumerate(bboxes):
            cls = box.best_class
            if cls not in self._est.class_2_encoder:
                box_xywhs.append(None)
                continue
            xywh = box.to_xywh(W, H)
            if np.any(np.array(xywh) < 0):
                box_xywhs.append(None)
                continue
            box_xywhs.append(xywh)
            by_class.setdefault(cls, []).append(j)

        want_depth = depth_img is not None and (
            self._est._use_icp or self._est._topk_rescore > 1
        )
        vals: Dict[str, List[torch.Tensor]] = {}
        idcs: Dict[str, List[torch.Tensor]] = {}
        prof = self._stage_timer()
        keep_vals = self._query_k > 1  # k=1 retrieve never reads the scores
        for cls, det_idcs in by_class.items():
            oi = self._oi_by_class[cls]
            chunk_vals, chunk_idcs = [], []
            for start in range(0, len(det_idcs), self.max_dets):
                chunk = det_idcs[start:start + self.max_dets]
                crops = np.zeros(
                    (self.max_dets, self.cfg0.h, self.cfg0.w, self.cfg0.c), np.uint8
                )
                with prof("crop_extract"):
                    for k, j in enumerate(chunk):
                        crops[k] = extract_square_patch_centered(
                            color_img,
                            box_xywhs[j],
                            self._est.pad_factors[cls],
                            resize=self._est.patch_sizes[cls],
                            interpolation="linear",
                            black_borders=True,
                        )
                with prof("dispatch"):
                    x = torch.from_numpy(crops).to(self.device)
                    z = self._models[cls].encode(x.to(torch.float32) / 255.0)
                    v, i = self._query(z, oi)
                    if keep_vals:
                        chunk_vals.append(self._to_host(v))
                    chunk_idcs.append(self._to_host(i))
            vals[cls] = chunk_vals
            idcs[cls] = chunk_idcs
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self.profile_frames += 1
        return _FrameHandle(
            vals=vals, idcs=idcs, ready=ready, by_class=by_class,
            box_xywhs=box_xywhs, bboxes=bboxes, camK=np.asarray(camK, np.float64),
            camPose=camPose, mm=mm, depth_img=depth_img if want_depth else None,
        )

    # --------------------------------------------------------------- retrieve
    def retrieve(self, h: _FrameHandle) -> List[PoseEstimate]:
        """Wait for a submitted frame and finish the pose math."""
        results: List[Optional[PoseEstimate]] = [None] * len(h.bboxes)
        prof = self._stage_timer()
        with prof("readback"):
            if h.ready is not None:
                h.ready.synchronize()
        for cls, det_idcs in h.by_class.items():
            n = len(det_idcs)
            # row c*max_dets+k is detection k of chunk c; every chunk but the
            # last is full, so flat row k IS detection k and [:n] drops pads
            with prof("readback"):
                cls_idcs = torch.cat(h.idcs[cls]).numpy()[:n]
                if self._query_k > 1:
                    cls_vals = torch.cat(h.vals[cls]).numpy()[:n]
            cfg = self._est.all_train_cfgs[cls]
            cb = self._est.all_codebooks[cls]
            pred_bbs = np.stack([h.box_xywhs[j] for j in det_idcs]).astype(np.float64)
            fixed_idcs = None
            with prof("pose_math"):
                if self._est._topk_aggregate > 1:
                    R0, rendered_bbs, _ = aggregate_candidates(
                        cb.viewsphere, cb.embed_obj_bbs, cls_idcs, cls_vals
                    )
                    Rs_cls, ts_cls = cb._solve_6d(R0, rendered_bbs, pred_bbs, h.camK, cfg)
                elif self._est._topk_rescore > 1 and h.depth_img is not None:
                    # expand all candidates, keep the best depth match
                    k = cls_idcs.shape[1]
                    Rs_f, ts_f = cb.pose6d_from_indices(cls_idcs, pred_bbs, h.camK, cfg)
                    Hd, Wd = h.depth_img.shape[:2]
                    best, _ = select_best_hypothesis(
                        self._est._icp_handle().renderers[cls].renderer,
                        h.camK, (Wd, Hd), h.depth_img,
                        Rs_f.reshape(n, k, 3, 3), ts_f.reshape(n, k, 3),
                        tau=self._est._rescore_tau,
                    )
                    rows = np.arange(n)
                    Rs_cls = Rs_f.reshape(n, k, 3, 3)[rows, best]
                    ts_cls = ts_f.reshape(n, k, 3)[rows, best]
                    fixed_idcs = cls_idcs[rows, best]
                else:
                    idcs_1 = cls_idcs[:, 0] if cls_idcs.ndim == 2 else cls_idcs
                    Rs_cls, ts_cls = cb.pose6d_from_indices(idcs_1, pred_bbs, h.camK, cfg)

            if h.depth_img is not None and self._est._use_icp:
                with prof("icp"):
                    depth_crops, crop_offsets = depth_crops_of(
                        h.depth_img, [h.box_xywhs[j] for j in det_idcs],
                        self._est.pad_factors[cls], h.depth_img.shape[:2],
                    )
                    # stage 2 re-uses the submit-time query: the encoder is
                    # deterministic, so encoding the same crops again would
                    # return exactly these candidates
                    if self._est._topk_aggregate > 1:
                        stage2, fixed = (cls_idcs, cls_vals), None
                    elif fixed_idcs is not None:
                        stage2, fixed = None, fixed_idcs
                    else:
                        stage2, fixed = None, cls_idcs[:, 0] if cls_idcs.ndim == 2 else cls_idcs
                    Rs_cls, ts_cls = self._est._icp_handle().refine_batch(
                        depth_crops, list(Rs_cls), list(ts_cls), h.camK,
                        h.depth_img.shape[:2][::-1], class_name=cls, codebook=cb,
                        det_bbs=pred_bbs, train_cfg=cfg, upright=self._est._upright,
                        topk_aggregate=self._est._topk_aggregate,
                        fixed_idcs=fixed, stage2_candidates=stage2,
                        crop_offsets=crop_offsets if self._est._icp_frame_accurate else None,
                    )

            for k, j in enumerate(det_idcs):
                H_est = np.eye(4)
                H_est[:3, :3] = Rs_cls[k]
                H_est[:3, 3] = ts_cls[k] if h.mm else np.asarray(ts_cls[k]) / 1000.0
                if h.camPose is not None:
                    H_est = h.camPose @ H_est
                results[j] = PoseEstimate(name=h.bboxes[j].best_class, trafo=H_est)
        return [r for r in results if r is not None]

    # ------------------------------------------------------------------ sync
    def process(self, bboxes, color_img, camK, camPose=None, mm=False, depth_img=None):
        """Synchronous single-frame path (AePoseEstimator-compatible)."""
        return self.retrieve(self.submit(bboxes, color_img, camK, camPose, mm, depth_img))

    def process_stream(self, frames: Iterable[Dict], depth: int = 2) -> Iterator[List[PoseEstimate]]:
        """Pipelined stream keeping `depth` frames in flight; each frame is a
        dict of submit() kwargs. retrieve() runs on one worker thread, so
        results come back in submit order."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        q: deque = deque()
        with ThreadPoolExecutor(max_workers=1) as ex:
            for frame in frames:
                q.append(ex.submit(self.retrieve, self.submit(**frame)))
                if len(q) > depth:
                    yield q.popleft().result()
            while q:
                yield q.popleft().result()
