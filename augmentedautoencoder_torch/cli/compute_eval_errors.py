"""`python -m augmentedautoencoder_torch.cli.compute_eval_errors <eval_dir>`
— re-score an existing eval dir (reference
auto_pose/eval/compute_eval_errors.py: re-runs error evaluation without
re-estimating poses; port of augmentedautoencoder_tpu/cli/compute_eval_errors.py).

Reads results.json (written by ae_eval), re-applies thresholds/matching with
possibly different metric parameters, and rewrites scores.json + plots.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

from ..evaluation import plots
from ..evaluation.matching import (
    EstimateErrors,
    error_threshold,
    match_and_eval_performance_scores,
)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Re-score `eval_dir`; returns the scores written to scores.json."""
    parser = argparse.ArgumentParser(prog="compute_eval_errors")
    parser.add_argument("eval_dir")
    parser.add_argument("--error_thresh", type=float, default=0.3)
    parser.add_argument("--error_thresh_deg", type=float, default=5.0)
    parser.add_argument("--error_thresh_mm", type=float, default=50.0)
    parser.add_argument("--model_diameter", type=float, default=None)
    parser.add_argument("--top_n_eval", type=int, default=1)
    args = parser.parse_args(argv)

    results_path = os.path.join(args.eval_dir, "results.json")
    with open(results_path) as fh:
        results = json.load(fh)
    if not results:
        raise SystemExit("no results in eval dir")

    error_types = sorted({k for r in results for k in r.get("errors", {})})
    scores = {}
    for et in error_types:
        ests = []
        n_gts = {}
        for r in results:
            if et not in r.get("errors", {}):
                continue
            key = (r["scene_id"], r["im_id"], r["obj_id"])
            n_gts[key] = n_gts.get(key, 0) + 1
            ests.append(
                EstimateErrors(
                    scene_id=r["scene_id"], im_id=r["im_id"], obj_id=r["obj_id"],
                    score=r.get("score", 1.0), errors={0: r["errors"][et]},
                )
            )
        thresh = error_threshold(
            et,
            error_thresh=args.error_thresh,
            error_thresh_deg=args.error_thresh_deg,
            error_thresh_mm=args.error_thresh_mm,
            model_diameter=args.model_diameter,
        )
        scores[et] = match_and_eval_performance_scores(
            ests, n_gts, thresh, n_top=args.top_n_eval
        )
        scores[et]["threshold"] = thresh
        errs = [r["errors"][et] for r in results if et in r.get("errors", {})]
        plots.plot_error_hist(errs, et, args.eval_dir)
        plots.plot_cumulative_error(errs, et, args.eval_dir, thresh)

    summary = {et: {k: v for k, v in s.items() if k != "per_image"} for et, s in scores.items()}
    with open(os.path.join(args.eval_dir, "scores.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    plots.plot_scores_bar(scores, args.eval_dir)
    for et, s in summary.items():
        print(f"{et}: recall={s['recall']:.4f} ({s['n_correct']}/{s['n_gt']})")
    return summary


if __name__ == "__main__":
    main()
