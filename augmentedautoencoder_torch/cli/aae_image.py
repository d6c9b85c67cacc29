"""`python -m augmentedautoencoder_torch.cli.aae_image <group>/<experiment> -f
<file_or_dir>` -- single-crop demo (port of augmentedautoencoder_tpu/cli/
aae_image.py; reference test/aae_image.py).

Estimates the nearest codebook rotation for image crop(s) (encoder + the
top-1 codebook query on the device) and writes the input beside the
re-rendered estimated view as `<name>_estimate.png`. Runs on the GPU; on
the CPU call `main([...], device="cpu")`. Images (PNG or JPEG) are decoded
by `utils/png.read_png` (PIL) and resized by
`pose.estimator.resize_linear_u8` (cv2.imread and cv2.resize's pixels), the
PNG written by `utils/png.write_png`.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import factory
from ..codebook import f32_without_tf32
from ..pose.estimator import resize_linear_u8
from ..utils.png import read_png, write_png
from . import split_experiment_name


def main(argv: Optional[Sequence[str]] = None, device=None) -> List[Dict]:
    """Returns, per image, its file, codebook row, rotation and output path."""
    parser = argparse.ArgumentParser(prog="aae_image")
    parser.add_argument("experiment_name")
    parser.add_argument("-f", "--file_str", required=True,
                        help="image file or folder of images")
    parser.add_argument("-o", "--out_dir", default=None)
    parser.add_argument("--at_step", type=int, default=None)
    args = parser.parse_args(argv)

    experiment_name, experiment_group = split_experiment_name(args.experiment_name)
    codebook, dataset = factory.build_codebook_from_name(
        experiment_name, experiment_group, return_dataset=True, at_step=args.at_step, device=device
    )

    if os.path.isdir(args.file_str):
        files = sorted(
            glob.glob(os.path.join(args.file_str, "*.png"))
            + glob.glob(os.path.join(args.file_str, "*.jpg"))
        )
    else:
        files = [args.file_str]

    out_dir = args.out_dir or os.getcwd()
    os.makedirs(out_dir, exist_ok=True)

    h, w = dataset.shape[:2]
    results = []
    for fname in files:
        im = resize_linear_u8(read_png(fname), (w, h))  # cv2.imread + cv2.resize
        with f32_without_tf32():
            idx = int(codebook.nearest_rotation(im, return_idcs=True)[0])
        R = codebook.viewsphere[idx]
        pred_view = dataset.render_rot(R)
        print(f"{os.path.basename(fname)}\nR_est:\n{R}")
        out = np.concatenate([im, pred_view.astype(np.uint8)], axis=1)
        out_path = os.path.join(
            out_dir, os.path.splitext(os.path.basename(fname))[0] + "_estimate.png"
        )
        write_png(out_path, out)
        print(f"wrote {out_path}")
        results.append({"file": fname, "idx": idx, "R": R, "out_path": out_path})
    return results


if __name__ == "__main__":
    main()
