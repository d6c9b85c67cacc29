"""Eval configuration (reference auto_pose/ae/cfg_eval/eval_template.cfg; copy
of augmentedautoencoder_tpu/config/eval_config.py)."""

from __future__ import annotations

import configparser
import dataclasses
from typing import List

from .safe_eval import safe_eval


@dataclasses.dataclass
class EvalConfig:
    # [METHOD]
    method: str = "aae"

    # [DATA]
    dataset: str = "tless"
    dataset_path: str = ""
    obj_id: int = 1
    scenes: List[int] = dataclasses.field(default_factory=list)
    obj_ids: List[int] = dataclasses.field(default_factory=list)
    cam_type: str = "primesense"

    # [BBOXES]
    estimate_bbs: bool = False
    est_bbs_type: str = "gt"
    detections_path: str = ""  # json: {scene: {im: [{obj_id, bbox, score}]}}
    single_instance: bool = True
    icp: bool = False
    gt_masks: bool = False
    # test-time aggregation (new capability; 1/1 = strict reference parity,
    # the single-argmax path): blend the top-k codebook matches / average
    # cosine votes over n jittered crops per detection (codebook.py
    # `aggregate_candidates` / `tta_jittered_bboxes`)
    topk_aggregate: int = 1
    tta_crops: int = 1
    # depth-based hypothesis re-scoring (pose/rescore.py): expand the top-k
    # matches into 6D hypotheses and keep the one whose rendered depth best
    # matches the observed depth (tau = vsd_tau). 1 = off. Mutually
    # exclusive with topk_aggregate.
    topk_rescore: int = 1
    # frame-accurate ICP cloud geometry (pose/icp.py _refinement_clouds):
    # render the synthetic depth at the estimated lateral position instead
    # of the reference's centered render — removes the off-center x/y bias.
    # False = strict reference geometry.
    icp_frame_accurate: bool = False

    # [EVALUATION]
    compute_errors: bool = True
    evaluate_errors: bool = True

    # [METRIC]
    error_types: List[str] = dataclasses.field(default_factory=lambda: ["vsd", "re", "te"])
    vsd_delta: float = 15.0
    vsd_tau: float = 20.0
    vsd_cost: str = "step"
    error_thresh: float = 0.3
    error_thresh_deg: float = 5.0
    error_thresh_mm: float = 50.0
    top_n_eval: int = 1
    top_n: int = 1

    # [PLOT] — per-figure toggles mirroring the reference's eval template
    # (auto_pose/ae/cfg_eval/eval_template.cfg:32-44; consumed by
    # auto_pose/eval/ae_eval.py:183-276). COMPUTE_PLOTS is this rebuild's
    # master switch; the per-plot keys default to the emission behaviour
    # the repo always had (analysis figures on, expensive PCA off).
    compute_plots: bool = True
    embedding_pca: bool = False
    viewsphere: bool = False
    reconstruction: bool = False
    nearest_neighbors: bool = True
    scene_with_estimate: bool = True
    cum_t_error_hist: bool = True
    cum_r_error_hist: bool = True
    cum_vsd_error_hist: bool = True
    vsd_occlusion: bool = True
    r_error_occlusion: bool = True
    reconstruction_test_batch: bool = True
    # the reference's animate_embedding_path is an empty stub
    # (eval_plots.py:664-665); here it writes a real embedding_path.gif
    animate_embedding_pca: bool = False


def load_eval_config(path_or_parser) -> EvalConfig:
    if isinstance(path_or_parser, configparser.ConfigParser):
        cp = path_or_parser
    else:
        cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
        with open(path_or_parser) as fh:
            cp.read_string(fh.read())

    cfg = EvalConfig()

    def get(section, option, default):
        if not cp.has_option(section, option):
            return default
        raw = cp.get(section, option)
        if isinstance(default, bool):
            return raw.strip().lower() in ("1", "true", "yes", "on")
        if isinstance(default, int):
            return int(float(safe_eval(raw)))
        if isinstance(default, float):
            return float(safe_eval(raw))
        if isinstance(default, str):
            return raw
        return safe_eval(raw)

    cfg.method = get("METHOD", "METHOD", cfg.method)
    cfg.dataset = get("DATA", "DATASET", cfg.dataset)
    cfg.dataset_path = get("DATA", "DATASET_PATH", cfg.dataset_path)
    cfg.obj_id = get("DATA", "OBJ_ID", cfg.obj_id)
    cfg.scenes = [int(s) for s in get("DATA", "SCENES", cfg.scenes)]
    cfg.obj_ids = [int(o) for o in get("DATA", "OBJ_IDS", cfg.obj_ids)]
    cfg.cam_type = get("DATA", "CAM_TYPE", cfg.cam_type)

    cfg.estimate_bbs = get("BBOXES", "ESTIMATE_BBS", cfg.estimate_bbs)
    cfg.est_bbs_type = get("BBOXES", "EST_BBS_TYPE", cfg.est_bbs_type)
    cfg.detections_path = get("BBOXES", "DETECTIONS_PATH", cfg.detections_path)
    cfg.single_instance = get("BBOXES", "SINGLE_INSTANCE", cfg.single_instance)
    cfg.icp = get("BBOXES", "ICP", cfg.icp)
    cfg.gt_masks = get("BBOXES", "GT_MASKS", cfg.gt_masks)
    cfg.topk_aggregate = get("BBOXES", "TOPK_AGGREGATE", cfg.topk_aggregate)
    cfg.tta_crops = get("BBOXES", "TTA_CROPS", cfg.tta_crops)
    cfg.topk_rescore = get("BBOXES", "TOPK_RESCORE", cfg.topk_rescore)
    cfg.icp_frame_accurate = get(
        "BBOXES", "ICP_FRAME_ACCURATE", cfg.icp_frame_accurate
    )
    if cfg.topk_rescore > 1 and cfg.topk_aggregate > 1:
        raise ValueError(
            "TOPK_RESCORE and TOPK_AGGREGATE are mutually exclusive: "
            "re-scoring picks one hypothesis, aggregation blends several"
        )

    cfg.compute_errors = get("EVALUATION", "COMPUTE_ERRORS", cfg.compute_errors)
    cfg.evaluate_errors = get("EVALUATION", "EVALUATE_ERRORS", cfg.evaluate_errors)

    cfg.error_types = [str(e) for e in get("METRIC", "ERROR_TYPES", cfg.error_types)]
    cfg.vsd_delta = get("METRIC", "VSD_DELTA", cfg.vsd_delta)
    cfg.vsd_tau = get("METRIC", "VSD_TAU", cfg.vsd_tau)
    cfg.vsd_cost = get("METRIC", "VSD_COST", cfg.vsd_cost)
    cfg.error_thresh = get("METRIC", "ERROR_THRESH", cfg.error_thresh)
    cfg.error_thresh_deg = get("METRIC", "ERROR_THRESH_DEG", cfg.error_thresh_deg)
    cfg.error_thresh_mm = get("METRIC", "ERROR_THRESH_MM", cfg.error_thresh_mm)
    cfg.top_n_eval = get("METRIC", "TOP_N_EVAL", cfg.top_n_eval)
    cfg.top_n = get("METRIC", "TOP_N", cfg.top_n)

    cfg.compute_plots = get("PLOT", "COMPUTE_PLOTS", cfg.compute_plots)
    cfg.embedding_pca = get("PLOT", "EMBEDDING_PCA", cfg.embedding_pca)
    cfg.viewsphere = get("PLOT", "VIEWSPHERE", cfg.viewsphere)
    cfg.reconstruction = get("PLOT", "RECONSTRUCTION", cfg.reconstruction)
    cfg.nearest_neighbors = get("PLOT", "NEAREST_NEIGHBORS", cfg.nearest_neighbors)
    cfg.scene_with_estimate = get(
        "PLOT", "SCENE_WITH_ESTIMATE", cfg.scene_with_estimate
    )
    cfg.cum_t_error_hist = get("PLOT", "CUM_T_ERROR_HIST", cfg.cum_t_error_hist)
    cfg.cum_r_error_hist = get("PLOT", "CUM_R_ERROR_HIST", cfg.cum_r_error_hist)
    cfg.cum_vsd_error_hist = get(
        "PLOT", "CUM_VSD_ERROR_HIST", cfg.cum_vsd_error_hist
    )
    cfg.vsd_occlusion = get("PLOT", "VSD_OCCLUSION", cfg.vsd_occlusion)
    cfg.r_error_occlusion = get("PLOT", "R_ERROR_OCCLUSION", cfg.r_error_occlusion)
    cfg.reconstruction_test_batch = get(
        "PLOT", "RECONSTRUCTION_TEST_BATCH", cfg.reconstruction_test_batch
    )
    cfg.animate_embedding_pca = get(
        "PLOT", "ANIMATE_EMBEDDING_PCA", cfg.animate_embedding_pca
    )
    return cfg
