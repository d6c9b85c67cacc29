"""The ae_eval loop: scenes -> crops -> pose -> errors -> scores -> report
(port of augmentedautoencoder_tpu/evaluation/evaluator.py).

Rebuild of auto_pose/eval/ae_eval.py: iterates test scenes, crops GT (or
externally detected) boxes, runs the batched codebook pose path on the
codebook's device (B3 at TOPK_AGGREGATE 1; + optional 3-stage ICP, whose
nearest-neighbour step is B4), computes the configured error metrics
(pose_errors; `adi` on B4, one lane per GT of the estimate), matches and
scores (matching), and writes sixd-style result files, a results and a
scores json. Every device stage batches an image's estimates: one readback
per stage per image. `Evaluator.seconds` sums the host clock per stage
(scene_load, crop, pose, icp, errors, matching, writing).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..codebook import tta_jittered_bboxes
from ..config import TrainConfig
from ..config.eval_config import EvalConfig
from ..data.dataset import extract_square_patch
from ..geometry.view_sampler import calc_2d_bbox
from . import pose_errors
from .matching import EstimateErrors, error_threshold, match_and_eval_performance_scores
from .scene_loader import SceneLoader, scene_dir_for
from .sixd_writer import write_sixd_results


@dataclasses.dataclass
class EvalResult:
    scene_id: int
    im_id: int
    obj_id: int
    R_est: np.ndarray
    t_est: np.ndarray
    score: float
    gt_idx: int
    run_time: float
    errors: Dict[str, float] = dataclasses.field(default_factory=dict)
    visib_fract: Optional[float] = None  # GT visibility for occlusion plots


class Evaluator:
    def __init__(
        self,
        codebook,
        train_cfg: TrainConfig,
        eval_cfg: EvalConfig,
        renderer=None,
        model_pts: Optional[np.ndarray] = None,
        model_diameter: Optional[float] = None,
        icp_handle=None,
        device=None,
    ):
        """`device` runs `adi` (default: the codebook's device)."""
        self.codebook = codebook
        self.device = device if device is not None else getattr(codebook, "device", None)
        self.seconds: Dict[str, float] = defaultdict(float)
        self.train_cfg = train_cfg
        self.eval_cfg = eval_cfg
        self.renderer = renderer
        self.model_pts = model_pts
        self.model_diameter = model_diameter
        self.icp_handle = icp_handle
        # grist for the analysis figures: first-16 eval crops (for the
        # reconstruction / nearest-neighbor grids) and one full-scene
        # overlay sample (raw + refined estimate)
        self._sample_crops: List[np.ndarray] = []
        self._overlay_sample: Optional[Dict] = None
        self._detections = None
        if eval_cfg.estimate_bbs and eval_cfg.detections_path:
            with open(eval_cfg.detections_path) as fh:
                self._detections = json.load(fh)

    @contextlib.contextmanager
    def _span(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[stage] += time.perf_counter() - t0

    def _extract_crops(self, img: np.ndarray, bb) -> List[np.ndarray]:
        """1 (plain) or TTA_CROPS (jitter-vote) square patches for one
        detection; entry 0 is always the unjittered crop."""
        n = max(self.eval_cfg.tta_crops, 1)
        bbs = tta_jittered_bboxes(bb, n) if n > 1 else [bb]
        return [
            extract_square_patch(
                img, b, self.train_cfg.pad_factor,
                resize=(self.train_cfg.w, self.train_cfg.h),
            )
            for b in bbs
        ]

    def _rescore_poses(self, crops_all, bbs, K_test, depth_img, dims, tta):
        """Depth re-scored 6D poses (pose/rescore.py): expand each
        detection's TOPK_RESCORE best codebook matches into hypotheses and
        keep the one whose rendered depth best matches the observed depth
        (tau = VSD_TAU). `depth_img` is loaded once by the caller (the ICP
        branch shares it). Returns (Rs (B,3,3), ts (B,3), idcs (B,))."""
        from ..pose.rescore import select_best_hypothesis

        ec = self.eval_cfg
        if self.renderer is None:
            raise ValueError("TOPK_RESCORE needs the object renderer")
        if depth_img is None:
            raise ValueError("TOPK_RESCORE needs depth test images")
        idcs_k, _ = self.codebook.topk_candidates(
            np.stack(crops_all), ec.topk_rescore, tta=tta
        )
        B, k = idcs_k.shape
        Rs_f, ts_f = self.codebook.pose6d_from_indices(
            idcs_k, np.stack(bbs), K_test, self.train_cfg
        )
        best, _ = select_best_hypothesis(
            self.renderer, K_test, dims, depth_img,
            Rs_f.reshape(B, k, 3, 3), ts_f.reshape(B, k, 3), tau=ec.vsd_tau,
        )
        rows = np.arange(B)
        return (
            Rs_f.reshape(B, k, 3, 3)[rows, best],
            ts_f.reshape(B, k, 3)[rows, best],
            idcs_k[rows, best],
        )

    # ------------------------------------------------------------- pose
    def estimate_image(
        self, loader: SceneLoader, scene_id: int, im_id: int
    ) -> List[EvalResult]:
        ec = self.eval_cfg
        all_gts = [
            (gi, g) for gi, g in enumerate(loader.gt[im_id]) if g.obj_id == ec.obj_id
        ]
        if not all_gts:
            return []
        # gt indices below refer to positions within the obj-filtered list,
        # matching compute_errors' enumeration
        sel = list(range(len(all_gts)))
        if ec.single_instance:
            # prefer the most visible instance when gt info carries
            # visibility fractions (reference eval_utils.py:209-227 selects
            # by score/visibility)
            if any(g.visib_fract is not None for _, g in all_gts):
                sel = [
                    max(
                        sel,
                        key=lambda i: all_gts[i][1].visib_fract
                        if all_gts[i][1].visib_fract is not None
                        else 0.0,
                    )
                ]
            else:
                sel = sel[:1]
        gts = [(i, all_gts[i][1]) for i in sel]

        with self._span("scene_load"):
            img = loader.load_rgb(im_id)
        K_test = loader.cameras[im_id]["K"]
        H, W = img.shape[:2]

        # external detections replace GT boxes (reference ae_eval.py:109-126
        # with EST_BBS_TYPE external yaml); gt_idx -1 marks "unassigned" —
        # errors are computed vs all GTs and matching assigns greedily
        if self._detections is not None:
            dets = (
                self._detections.get(str(scene_id), {}).get(str(im_id), [])
            )
            dets = [d for d in dets if int(d.get("obj_id", ec.obj_id)) == ec.obj_id]
            results = []
            if not dets:
                return []
            crops_d, bbs_d, scores = [], [], []
            with self._span("crop"):
                for d in dets:
                    crops_d.extend(self._extract_crops(img, d["bbox"]))
                    bbs_d.append(d["bbox"])
                    scores.append(float(d.get("score", 1.0)))
            depth_d = None
            if ec.topk_rescore > 1:
                with self._span("scene_load"):
                    depth_d = loader.load_depth(im_id)
            t0 = time.time()
            with self._span("pose"):
                if ec.topk_rescore > 1:
                    Rs, ts, _ = self._rescore_poses(
                        crops_d, bbs_d, K_test, depth_d, (W, H),
                        max(ec.tta_crops, 1),
                    )
                else:
                    Rs, ts, _ = self.codebook.auto_pose6d_batch(
                        np.stack(crops_d), np.stack(bbs_d), K_test, self.train_cfg,
                        topk_aggregate=ec.topk_aggregate, tta=max(ec.tta_crops, 1),
                    )
            aae_time = time.time() - t0
            for k in range(len(dets)):
                results.append(
                    EvalResult(
                        scene_id=scene_id, im_id=im_id, obj_id=ec.obj_id,
                        R_est=Rs[k], t_est=ts[k], score=scores[k], gt_idx=-1,
                        run_time=aae_time / len(dets),
                    )
                )
            return results

        crops, crops_all, bbs, gt_idcs = [], [], [], []
        for gi, gt in gts:
            bb = gt.bbox_obj
            if bb is None and self.renderer is not None:
                with self._span("crop"):
                    _, depth = self.renderer.render(
                        0, W, H, K_test, gt.R, gt.t, 10.0, 10000.0, random_light=False
                    )
                    ys, xs = np.nonzero(depth > 0)
                if len(xs) == 0:
                    continue
                bb = calc_2d_bbox(xs, ys, (W, H))
            if bb is None:
                continue
            src_img = img
            if ec.gt_masks:
                # reference BOP script zeroes the background with the
                # instance's visible mask before estimation
                # (compute_bop_results_m3.py:162-166); mask files are named
                # by the instance's position in the FULL scene_gt list, so
                # use all_gts' original index, not the obj-filtered one
                with self._span("scene_load"):
                    m = loader.load_mask_visib(im_id, all_gts[gi][0])
                if m is not None:
                    src_img = img * m[..., None].astype(img.dtype)
            with self._span("crop"):
                det_crops = self._extract_crops(src_img, bb)
            crops.append(det_crops[0])  # unjittered: figures + ICP clouds
            crops_all.extend(det_crops)
            bbs.append(bb)
            gt_idcs.append(gi)

        if not crops:
            return []

        tta = max(ec.tta_crops, 1)
        # one depth read serves both the re-scoring and the ICP branch
        depth = None
        if ec.topk_rescore > 1 or (ec.icp and self.icp_handle is not None):
            with self._span("scene_load"):
                depth = loader.load_depth(im_id)
        t0 = time.time()
        with self._span("pose"):
            if ec.topk_rescore > 1:
                Rs, ts, idcs = self._rescore_poses(
                    crops_all, bbs, K_test, depth, (W, H), tta
                )
            else:
                Rs, ts, idcs = self.codebook.auto_pose6d_batch(
                    np.stack(crops_all), np.stack(bbs), K_test, self.train_cfg,
                    topk_aggregate=ec.topk_aggregate, tta=tta,
                )
        aae_time = time.time() - t0

        if len(self._sample_crops) < 16:
            self._sample_crops.extend(crops[: 16 - len(self._sample_crops)])
        stash_overlay = self._overlay_sample is None
        if stash_overlay:
            self._overlay_sample = {
                "img": img, "K": K_test, "bbox": bbs[0], "dims": (W, H),
                "obj_id": ec.obj_id, "score": 1.0,
                "R_raw": np.array(Rs[0]), "t_raw": np.array(ts[0]),
                "R_refined": None, "t_refined": None,
            }

        if ec.icp and self.icp_handle is not None:
            t1 = time.time()
            with self._span("icp"):
                Rs, ts = self._refine(depth, Rs, ts, idcs, K_test, W, H, crops, crops_all, bbs, tta)
            aae_time += time.time() - t1
            if stash_overlay:
                self._overlay_sample["R_refined"] = np.array(Rs[0])
                self._overlay_sample["t_refined"] = np.array(ts[0])

        vis_by_gi = {gi: g.visib_fract for gi, g in gts}
        results = []
        for k, gi in enumerate(gt_idcs):
            results.append(
                EvalResult(
                    scene_id=scene_id, im_id=im_id, obj_id=ec.obj_id,
                    R_est=Rs[k], t_est=ts[k], score=1.0, gt_idx=gi,
                    run_time=aae_time / len(gt_idcs),
                    visib_fract=vis_by_gi.get(gi),
                )
            )
        return results

    def _refine(self, depth, Rs, ts, idcs, K_test, W, H, crops, crops_all, bbs, tta):
        """The 3-stage ICP of one image's estimates on square bbox-centred
        depth crops, un-resized (reference eval_utils.py:105-118):
        icp_refinement re-centres K on the crop, which is only correct for
        this crop geometry."""
        ec = self.eval_cfg
        depth_crops, crop_offsets = [], []
        for x, y, w, h in bbs:
            size = int(max(h, w) * self.train_cfg.pad_factor)
            left = int(max(x + w / 2 - size / 2, 0))
            right = int(min(x + w / 2 + size / 2, W))
            top = int(max(y + h / 2 - size / 2, 0))
            bottom = int(min(y + h / 2 + size / 2, H))
            depth_crops.append(depth[top:bottom, left:right])
            crop_offsets.append((left, top))
        # every device stage batches across the frame's estimates —
        # one dispatch + one fetch per stage, not per estimate
        if hasattr(self.icp_handle, "refine_batch"):
            return self.icp_handle.refine_batch(
                depth_crops, Rs, ts, K_test, (W, H),
                codebook=self.codebook, det_imgs=crops_all,
                det_bbs=np.stack(bbs), train_cfg=self.train_cfg,
                topk_aggregate=ec.topk_aggregate, tta=tta,
                fixed_idcs=idcs if ec.topk_rescore > 1 else None,
                crop_offsets=crop_offsets if ec.icp_frame_accurate else None,
            )
        # a custom handle exposing only per-estimate refine()
        Rs, ts = list(Rs), list(ts)
        for k in range(len(bbs)):
            Rs[k], ts[k] = self.icp_handle.refine(
                depth_crops[k], Rs[k], ts[k], K_test, (W, H),
                codebook=self.codebook, det_img=crops[k],
                det_bb=bbs[k], train_cfg=self.train_cfg,
            )
        return Rs, ts

    # ------------------------------------------------------------- errors
    def compute_errors(
        self, loader: SceneLoader, result: EvalResult
    ) -> Dict[str, Dict[int, float]]:
        """Each configured error of `result` against every GT of its object
        in its image; `adi` against all of them in one B4 call."""
        ec = self.eval_cfg
        gts = [g for g in loader.gt[result.im_id] if g.obj_id == ec.obj_id]
        depth_test = None
        if "vsd" in ec.error_types:
            with self._span("scene_load"):
                depth_test = loader.load_depth(result.im_id)
        K_test = loader.cameras[result.im_id]["K"]

        per_type: Dict[str, Dict[int, float]] = {t: {} for t in ec.error_types}
        with self._span("errors"):
            for et in ec.error_types:
                if et == "adi":
                    vals = pose_errors.adi_many(
                        [(result.R_est, result.t_est, gt.R, gt.t) for gt in gts],
                        self.model_pts, self.device,
                    )
                    per_type[et] = dict(enumerate(vals))
                    continue
                for gi, gt in enumerate(gts):
                    per_type[et][gi] = pose_errors.calc_error(
                        et, result.R_est, result.t_est, gt.R, gt.t,
                        pts=self.model_pts, K=K_test, depth_test=depth_test,
                        renderer=self.renderer,
                        vsd_delta=ec.vsd_delta, vsd_tau=ec.vsd_tau, vsd_cost=ec.vsd_cost,
                    )
        return per_type

    # ------------------------------------------------------------- run
    def run(self, eval_dir: str, progress: bool = True) -> Dict:
        ec = self.eval_cfg
        os.makedirs(eval_dir, exist_ok=True)

        all_results: List[EvalResult] = []
        estimates_per_type: Dict[str, List[EstimateErrors]] = {
            t: [] for t in ec.error_types
        }
        n_gts: Dict[Tuple[int, int, int], int] = {}

        for scene_id in ec.scenes:
            with self._span("scene_load"):
                loader = SceneLoader(
                    scene_dir_for(ec.dataset_path, scene_id, ec.cam_type)
                )
            for im_id in loader.im_ids:
                gts = [g for g in loader.gt[im_id] if g.obj_id == ec.obj_id]
                if not gts:
                    continue
                n_valid = 1 if ec.single_instance else len(gts)
                n_gts[(scene_id, im_id, ec.obj_id)] = n_valid

                results = self.estimate_image(loader, scene_id, im_id)
                for r in results:
                    if ec.compute_errors:
                        errs = self.compute_errors(loader, r)
                        if r.gt_idx >= 0:
                            r.errors = {t: errs[t][r.gt_idx] for t in ec.error_types}
                        else:  # external detection: report best-GT error
                            r.errors = {
                                t: min(errs[t].values()) for t in ec.error_types
                            }
                        for et in ec.error_types:
                            estimates_per_type[et].append(
                                EstimateErrors(
                                    scene_id=scene_id, im_id=im_id,
                                    obj_id=ec.obj_id, score=r.score,
                                    errors=errs[et],
                                )
                            )
                    all_results.append(r)
                if progress and im_id % 50 == 0:
                    print(f"scene {scene_id} image {im_id}: {len(all_results)} estimates")

        # ---- scoring
        scores = {}
        with self._span("matching"):
            if ec.evaluate_errors:
                for et in ec.error_types:
                    thresh = error_threshold(
                        et,
                        error_thresh=ec.error_thresh,
                        error_thresh_deg=ec.error_thresh_deg,
                        error_thresh_mm=ec.error_thresh_mm,
                        model_diameter=self.model_diameter,
                    )
                    scores[et] = match_and_eval_performance_scores(
                        estimates_per_type[et], n_gts, thresh, n_top=ec.top_n_eval
                    )
                    scores[et]["threshold"] = thresh

        # ---- persist: sixd17 per-view ymls + per-estimate results + scores
        with self._span("writing"):
            write_sixd_results(eval_dir, all_results)
            results_json = [
                {
                    "scene_id": r.scene_id, "im_id": r.im_id, "obj_id": r.obj_id,
                    "R": r.R_est.ravel().tolist(), "t": r.t_est.ravel().tolist(),
                    "score": r.score, "time": r.run_time, "errors": r.errors,
                }
                for r in all_results
            ]
            with open(os.path.join(eval_dir, "results.json"), "w") as fh:
                json.dump(results_json, fh, indent=1)
            score_summary = {
                et: {k: v for k, v in s.items() if k != "per_image"}
                for et, s in scores.items()
            }
            with open(os.path.join(eval_dir, "scores.json"), "w") as fh:
                json.dump(score_summary, fh, indent=1)

        return {
            "results": all_results,
            "scores": scores,
            "sample_crops": self._sample_crops,
            "overlay_sample": self._overlay_sample,
        }
