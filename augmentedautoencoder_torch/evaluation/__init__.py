"""Evaluation: pose-error metrics, 6D localization scoring, BOP results
(port of augmentedautoencoder_tpu/evaluation/).

Native equivalents of the reference's external sixd_toolkit dependency and
its extensions (sixd_toolkit_extensions/eval_calc_errors.py, eval_loc.py)
and the BOP CSV writer (m3_interface/compute_bop_results_m3.py).
"""

from . import pose_errors
from .bop_writer import write_bop_csv
from .matching import match_and_eval_performance_scores

__all__ = ["pose_errors", "match_and_eval_performance_scores", "write_bop_csv"]
