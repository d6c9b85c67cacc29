"""sixd17 per-view result files — the format external sixd tooling consumes
(copy of augmentedautoencoder_tpu/evaluation/sixd_writer.py).

The reference writes one `<im_id:04d>_<obj_id:02d>.yml` per evaluated view
into `<eval_dir>/<scene_id:02d>/` via sixd_toolkit's
`inout.save_results_sixd17` (auto_pose/eval/ae_eval.py:241-243). This module
produces the same grammar so results drop into existing sixd pipelines:

    run_time: <seconds or -1>
    ests:
    - {score: 1.00000000, R: [r11, ..., r33], t: [tx, ty, tz]}

R is the 3x3 rotation flattened row-major; t is in millimetres.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np


def save_results_sixd17(path: str, res: Dict, run_time: float = -1) -> None:
    """res: {'ests': [{'score': float, 'R': (3,3), 't': (3,)} ...]}."""
    lines = [f"run_time: {run_time}", "ests:"]
    for est in res.get("ests", []):
        r = np.asarray(est["R"], dtype=np.float64).ravel()
        t = np.asarray(est["t"], dtype=np.float64).ravel()
        rs = ", ".join(f"{v:.8f}" for v in r)
        ts = ", ".join(f"{v:.8f}" for v in t)
        lines.append(
            "- {score: %.8f, R: [%s], t: [%s]}" % (float(est["score"]), rs, ts)
        )
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def load_results_sixd17(path: str) -> Dict:
    """Parse a sixd17 result yml (the restricted grammar written above and
    by sixd_toolkit; no yaml dependency needed)."""
    import re

    out: Dict = {"run_time": -1.0, "ests": []}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("run_time:"):
                out["run_time"] = float(line.split(":", 1)[1])
            elif line.startswith("- {"):
                score = float(re.search(r"score:\s*([-\d.eE+]+)", line).group(1))
                r = [float(v) for v in re.search(r"R:\s*\[([^\]]*)\]", line).group(1).split(",")]
                t = [float(v) for v in re.search(r"t:\s*\[([^\]]*)\]", line).group(1).split(",")]
                out["ests"].append(
                    {
                        "score": score,
                        "R": np.asarray(r).reshape(3, 3),
                        "t": np.asarray(t),
                    }
                )
    return out


def write_sixd_results(eval_dir: str, results: Sequence) -> List[str]:
    """Group EvalResults by (scene, view) and write one sixd17 yml each:
    <eval_dir>/<scene:02d>/<im:04d>_<obj:02d>.yml (reference layout,
    ae_eval.py:146,242). Returns the written paths."""
    grouped: Dict = {}
    for r in results:
        grouped.setdefault((r.scene_id, r.im_id, r.obj_id), []).append(r)
    paths = []
    for (scene_id, im_id, obj_id), rs in sorted(grouped.items()):
        scene_dir = os.path.join(eval_dir, f"{scene_id:02d}")
        os.makedirs(scene_dir, exist_ok=True)
        path = os.path.join(scene_dir, f"{im_id:04d}_{obj_id:02d}.yml")
        save_results_sixd17(
            path,
            {
                "ests": [
                    {"score": r.score, "R": r.R_est, "t": r.t_est} for r in rs
                ]
            },
            run_time=float(sum(r.run_time for r in rs)),
        )
        paths.append(path)
    return paths
