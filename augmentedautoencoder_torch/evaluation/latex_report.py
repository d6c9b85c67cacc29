"""LaTeX evaluation report (reference auto_pose/eval/latex_report.py; copy of
augmentedautoencoder_tpu/evaluation/latex_report.py).

Builds report.tex from the experiment/eval configs, score tables, and every
figure in the eval dir; compiles with pdflatex when available (the .tex is
the artifact either way).
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
from typing import Dict, List


_PREAMBLE = r"""\documentclass[a4paper]{article}
\usepackage{graphicx}
\usepackage{booktabs}
\usepackage[margin=2.5cm]{geometry}
\begin{document}
"""


def _escape(s: str) -> str:
    for c in "&%$#_{}":
        s = s.replace(c, "\\" + c)
    return s


class Report:
    def __init__(self, eval_dir: str, title: str = "AAE evaluation"):
        self.eval_dir = eval_dir
        self.title = title
        self.sections: List[str] = []

    def add_config_section(self, name: str, cfg_text: str) -> None:
        self.sections.append(
            f"\\section*{{{_escape(name)}}}\n"
            "\\begin{verbatim}\n" + cfg_text[:4000] + "\n\\end{verbatim}\n"
        )

    def add_scores_table(self, scores: Dict[str, Dict]) -> None:
        rows = []
        for et, s in scores.items():
            rows.append(
                f"{_escape(et)} & {s.get('threshold', '-')} & "
                f"{s['recall']:.4f} & {s['n_correct']}/{s['n_gt']} \\\\"
            )
        table = (
            "\\section*{Scores}\n\\begin{tabular}{lrrr}\n\\toprule\n"
            "metric & threshold & recall & correct/gt \\\\\n\\midrule\n"
            + "\n".join(rows)
            + "\n\\bottomrule\n\\end{tabular}\n"
        )
        self.sections.append(table)

    def add_figures(self) -> None:
        figs = sorted(glob.glob(os.path.join(self.eval_dir, "*.png")))
        if not figs:
            return
        body = ["\\section*{Figures}"]
        for f in figs:
            body.append(
                "\\begin{figure}[h]\\centering"
                f"\\includegraphics[width=0.6\\textwidth]{{{os.path.basename(f)}}}"
                f"\\caption{{{_escape(os.path.basename(f))}}}\\end{{figure}}"
            )
        self.sections.append("\n".join(body) + "\n\\clearpage\n")

    def write(self, compile_pdf: bool = True) -> str:
        tex = _PREAMBLE + f"\\title{{{_escape(self.title)}}}\\maketitle\n"
        tex += "\n".join(self.sections) + "\n\\end{document}\n"
        tex_path = os.path.join(self.eval_dir, "report.tex")
        with open(tex_path, "w") as fh:
            fh.write(tex)
        if compile_pdf and shutil.which("pdflatex"):
            try:
                subprocess.run(
                    ["pdflatex", "-interaction=nonstopmode", "report.tex"],
                    cwd=self.eval_dir, capture_output=True, timeout=120,
                )
            except Exception:
                pass
        return tex_path


def generate_report(eval_dir: str, title: str, train_cfg_text: str = "",
                    eval_cfg_text: str = "") -> str:
    """One-call report from an eval dir produced by the Evaluator."""
    report = Report(eval_dir, title)
    if train_cfg_text:
        report.add_config_section("Train config", train_cfg_text)
    if eval_cfg_text:
        report.add_config_section("Eval config", eval_cfg_text)
    scores_path = os.path.join(eval_dir, "scores.json")
    if os.path.exists(scores_path):
        with open(scores_path) as fh:
            report.add_scores_table(json.load(fh))
    report.add_figures()
    return report.write()
