"""Comparative report across an experiment group (a framework-neutral copy
of augmentedautoencoder_tpu/evaluation/comparative_report.py; reference
auto_pose/eval/comparative_report.py).

Globs every experiment's eval scores under a workspace group and aggregates
them into one LaTeX comparison table + a summary json.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

from .latex_report import _escape


def collect_scores(workspace_path: str, experiment_group: str = "") -> List[Dict]:
    """Find all scores.json under experiments/<group>/*/eval/*/*/."""
    pattern = os.path.join(
        workspace_path, "experiments", experiment_group, "*", "eval", "*", "*",
        "scores.json",
    )
    rows = []
    for path in sorted(glob.glob(pattern)):
        parts = path.split(os.sep)  # .../<experiment>/eval/<eval>/<data>/scores.json
        experiment = parts[-5]
        eval_name = parts[-3]
        data = parts[-2]
        with open(path) as fh:
            scores = json.load(fh)
        rows.append(
            {
                "experiment": experiment,
                "eval": eval_name,
                "data": data,
                "scores": scores,
            }
        )
    return rows


def write_comparative_report(
    workspace_path: str, experiment_group: str, out_dir: str
) -> str:
    rows = collect_scores(workspace_path, experiment_group)
    os.makedirs(out_dir, exist_ok=True)

    metrics = sorted({m for r in rows for m in r["scores"]})
    lines = [
        "\\documentclass[a4paper]{article}\\usepackage{booktabs}"
        "\\usepackage[margin=2cm]{geometry}\\begin{document}",
        f"\\section*{{Comparison: {_escape(experiment_group or 'all')}}}",
        "\\begin{tabular}{ll" + "r" * len(metrics) + "}",
        "\\toprule",
        "experiment & eval & "
        + " & ".join(_escape(m) for m in metrics)
        + " \\\\",
        "\\midrule",
    ]
    for r in rows:
        cells = [
            f"{r['scores'][m]['recall']:.4f}" if m in r["scores"] else "-"
            for m in metrics
        ]
        lines.append(
            f"{_escape(r['experiment'])} & {_escape(r['eval'])} & "
            + " & ".join(cells)
            + " \\\\"
        )
    lines += ["\\bottomrule", "\\end{tabular}", "\\end{document}"]

    tex_path = os.path.join(out_dir, "comparative_report.tex")
    with open(tex_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(os.path.join(out_dir, "comparative_scores.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return tex_path
