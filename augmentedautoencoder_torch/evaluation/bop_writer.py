"""BOP19 results CSV writer (m3_interface/compute_bop_results_m3.py:183-188;
copy of augmentedautoencoder_tpu/evaluation/bop_writer.py).

Format: scene_id,im_id,obj_id,score,R,t,time — R row-major space-separated,
t in mm, time in seconds; filename `<method>_<dataset>-<split>.csv`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class BopEstimate:
    scene_id: int
    im_id: int
    obj_id: int
    score: float
    R: np.ndarray  # 3x3
    t: np.ndarray  # 3, mm
    time: float  # seconds (per-image total: detection + pose)


def format_bop_row(e: BopEstimate) -> str:
    R_str = " ".join(f"{v:.8f}" for v in np.asarray(e.R).ravel())
    t_str = " ".join(f"{v:.8f}" for v in np.asarray(e.t).ravel())
    return f"{e.scene_id},{e.im_id},{e.obj_id},{e.score:.8f},{R_str},{t_str},{e.time:.8f}"


def write_bop_csv(
    estimates: Sequence[BopEstimate],
    out_dir: str,
    method: str,
    dataset: str,
    split: str = "test",
) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{method}_{dataset}-{split}.csv")
    with open(path, "w") as fh:
        fh.write("scene_id,im_id,obj_id,score,R,t,time\n")
        for e in estimates:
            fh.write(format_bop_row(e) + "\n")
    return path


def read_bop_csv(path: str) -> List[BopEstimate]:
    out = []
    with open(path) as fh:
        header = fh.readline()
        for line in fh:
            parts = line.strip().split(",")
            if len(parts) < 7:
                continue
            out.append(
                BopEstimate(
                    scene_id=int(parts[0]),
                    im_id=int(parts[1]),
                    obj_id=int(parts[2]),
                    score=float(parts[3]),
                    R=np.fromstring(parts[4], sep=" ").reshape(3, 3),
                    t=np.fromstring(parts[5], sep=" "),
                    time=float(parts[6]),
                )
            )
    return out
