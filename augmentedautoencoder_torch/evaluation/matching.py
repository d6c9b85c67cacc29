"""6D localization matching & scoring (sixd_toolkit_extensions/eval_loc.py;
copy of augmentedautoencoder_tpu/evaluation/matching.py).

Greedy estimate->GT matching per image: estimates sorted by confidence, each
matched to the not-yet-taken GT with the lowest error, counted correct when
the error clears the metric's threshold. Recall = matched / visible GTs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class EstimateErrors:
    """Errors of one pose estimate against every GT instance in its image."""

    scene_id: int
    im_id: int
    obj_id: int
    score: float
    errors: Dict[int, float]  # gt instance index -> error value


def error_threshold(
    error_type: str,
    *,
    error_thresh: float = 0.3,
    error_thresh_deg: float = 5.0,
    error_thresh_mm: float = 50.0,
    model_diameter: Optional[float] = None,
    diameter_factor: float = 0.1,
) -> float:
    """Per-metric correctness threshold (eval_template.cfg:22-28 semantics:
    vsd/cou use ERROR_THRESH, re ERROR_THRESH_DEG, te ERROR_THRESH_MM,
    add/adi 10% of the model diameter)."""
    if error_type in ("vsd", "cou"):
        return error_thresh
    if error_type == "re":
        return error_thresh_deg
    if error_type == "te":
        return error_thresh_mm
    if error_type in ("add", "adi", "proj"):
        if model_diameter is None:
            raise ValueError(f"{error_type} threshold needs the model diameter")
        return diameter_factor * model_diameter
    raise ValueError(f"unknown error type: {error_type}")


def match_poses(
    estimates: Sequence[EstimateErrors], threshold: float, n_top: int = 1
) -> List[Tuple[EstimateErrors, Optional[int]]]:
    """Greedy matching within one (scene, image, object) group.

    Returns [(estimate, matched_gt_index or None)] with estimates processed
    in descending score order; each GT matches at most once. n_top > 0 keeps
    only the top-n estimates by score (BOP n_top semantics); n_top <= 0
    keeps all.
    """
    est_sorted = sorted(estimates, key=lambda e: -e.score)
    if n_top > 0:
        est_sorted = est_sorted[:n_top]
    taken = set()
    out = []
    for est in est_sorted:
        best_gt, best_err = None, None
        for gt_idx, err in est.errors.items():
            if gt_idx in taken or err > threshold:
                continue
            if best_err is None or err < best_err:
                best_gt, best_err = gt_idx, err
        if best_gt is not None:
            taken.add(best_gt)
        out.append((est, best_gt))
    return out


def match_and_eval_performance_scores(
    all_estimates: Sequence[EstimateErrors],
    n_gts: Dict[Tuple[int, int, int], int],
    threshold: float,
    n_top: int = 1,
) -> Dict:
    """Score a full run.

    all_estimates: errors for every estimate; n_gts: (scene, im, obj) ->
    number of valid (sufficiently visible) GT instances.
    Returns {'recall', 'precision', 'n_correct', 'n_gt', 'n_est', 'per_image'}.
    """
    groups: Dict[Tuple[int, int, int], List[EstimateErrors]] = {}
    for est in all_estimates:
        groups.setdefault((est.scene_id, est.im_id, est.obj_id), []).append(est)

    n_correct = 0
    n_est_total = 0
    per_image = {}
    for key, ests in groups.items():
        matches = match_poses(ests, threshold, n_top)
        correct = sum(1 for _, gt in matches if gt is not None)
        n_correct += correct
        n_est_total += len(matches)
        per_image[key] = {"n_correct": correct, "n_est": len(matches)}

    n_gt_total = sum(n_gts.values())
    return {
        "recall": n_correct / n_gt_total if n_gt_total else 0.0,
        "precision": n_correct / n_est_total if n_est_total else 0.0,
        "n_correct": n_correct,
        "n_gt": n_gt_total,
        "n_est": n_est_total,
        "per_image": per_image,
    }
