"""pgfplots (.tex) export for evaluation figures (copy of
augmentedautoencoder_tpu/evaluation/tikz.py).

The reference exports its error histograms / cumulative curves to tikz via
matplotlib2tikz for direct inclusion in papers
(auto_pose/eval/eval_plots.py:303-431). matplotlib2tikz isn't in this image
(and converts rendered figures); instead these writers emit clean pgfplots
axes straight from the underlying data — same use case (\\input-able .tex),
more readable output.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _coords(xs, ys) -> str:
    return " ".join(f"({float(x):g},{float(y):g})" for x, y in zip(xs, ys))


def write_hist_tikz(
    errors: Sequence[float], error_type: str, out_dir: str, bins: int = 30
) -> str:
    """Histogram as a pgfplots ybar interval axis (eval_plots.py:336-359)."""
    errs = np.asarray(errors, dtype=np.float64)
    counts, edges = np.histogram(errs, bins=bins)
    body = _coords(edges[:-1], counts) + f" ({edges[-1]:g},{counts[-1]:g})"
    tex = (
        "% error histogram (" + error_type + ", "
        + str(len(errs)) + " estimates)\n"
        "\\begin{tikzpicture}\n"
        "\\begin{axis}[ybar interval, xlabel={" + error_type + " error}, "
        "ylabel={count}, ymin=0]\n"
        "\\addplot+[] coordinates {" + body + "};\n"
        "\\end{axis}\n\\end{tikzpicture}\n"
    )
    path = os.path.join(out_dir, f"error_hist_{error_type}.tex")
    with open(path, "w") as fh:
        fh.write(tex)
    return path


def write_cumulative_tikz(
    errors: Sequence[float],
    error_type: str,
    out_dir: str,
    threshold: Optional[float] = None,
) -> str:
    """Cumulative recall-vs-error curve (eval_plots.py:303-334)."""
    errs = np.sort(np.asarray(errors, dtype=np.float64))
    frac = np.arange(1, len(errs) + 1) / len(errs)
    lines = [
        "% cumulative " + error_type + " error",
        "\\begin{tikzpicture}",
        "\\begin{axis}[xlabel={" + error_type + " error}, ylabel={recall}, "
        "ymin=0, ymax=1]",
        "\\addplot+[mark=none] coordinates {" + _coords(errs, frac) + "};",
    ]
    if threshold is not None:
        lines.append(
            "\\draw[red, dashed] (axis cs:%g,0) -- (axis cs:%g,1);"
            % (threshold, threshold)
        )
    lines += ["\\end{axis}", "\\end{tikzpicture}", ""]
    path = os.path.join(out_dir, f"cumulative_{error_type}.tex")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    return path


def write_boxplot_tikz(
    bin_values: Sequence[np.ndarray],
    positions: Sequence[float],
    stem: str,
    out_dir: str,
    counts: Optional[Sequence[int]] = None,
) -> str:
    """Occlusion-binned boxplots as pgfplots `boxplot prepared` marks
    (reference exports vsd_occlusion.tex / R_err_occlusion.tex via
    matplotlib2tikz, eval_plots.py:605,662). Empty bins are skipped but
    keep their position so the visibility axis stays calibrated."""
    lines = [
        "% " + stem + (f" bin counts {list(counts)}" if counts is not None else ""),
        "\\begin{tikzpicture}",
        "\\begin{axis}[boxplot/draw direction=y, xlabel={visibility "
        "[fraction]}, ylabel={" + stem.replace("_", " ") + "}, xmin=0, xmax=1]",
    ]
    for pos, vals in zip(positions, bin_values):
        vals = np.asarray(vals, np.float64)
        if vals.size == 0:
            continue
        # matplotlib's default whisker semantics (whis=1.5) so the .tex twin
        # matches the PNG: whiskers at the farthest data within 1.5*IQR of
        # the quartiles, points beyond drawn as outlier marks
        q1, med, q3 = np.percentile(vals, [25, 50, 75])
        iqr = q3 - q1
        inliers = vals[(vals >= q1 - 1.5 * iqr) & (vals <= q3 + 1.5 * iqr)]
        lo_w, hi_w = inliers.min(), inliers.max()
        fliers = vals[(vals < lo_w) | (vals > hi_w)]
        coords = " ".join(f"(0,{v:g})" for v in fliers)
        lines.append(
            "\\addplot+[boxplot prepared={draw position=%g, lower whisker=%g, "
            "lower quartile=%g, median=%g, upper quartile=%g, upper whisker=%g, "
            "box extend=%g}] coordinates {%s};"
            % (pos, lo_w, q1, med, q3, hi_w, 0.05, coords)
        )
    lines += ["\\end{axis}", "\\end{tikzpicture}", ""]
    path = os.path.join(out_dir, f"{stem}.tex")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    return path
