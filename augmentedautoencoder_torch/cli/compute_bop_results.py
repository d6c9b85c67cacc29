"""`python -m augmentedautoencoder_torch.cli.compute_bop_results <test_config>
--dataset_path P --dataset_name N` — produce a BOP19 submission CSV
(reference auto_pose/m3_interface/compute_bop_results_m3.py; port of
augmentedautoencoder_tpu/cli/compute_bop_results.py) with the port's
AePoseEstimator: its codebook top-1 is B3 and, with `use_icp`, its ICP's
nearest neighbour B4. Runs on the GPU: without CUDA it raises unless
`main` is given device="cpu".

Iterates `test_targets_bop19.json`, estimates each target's pose from GT
visible masks (or plain GT bboxes), accumulates per-image time =
detection time + AAE time, and writes
`<method>_<dataset>-<split>.csv`.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

from ..evaluation.bop_writer import BopEstimate, write_bop_csv
from ..evaluation.scene_loader import SceneLoader, scene_dir_for
from ..pose.estimator import AePoseEstimator
from ..pose.interfaces import BoundingBox


def main(argv: Optional[Sequence[str]] = None, device=None) -> str:
    """Write the CSV; returns its path."""
    parser = argparse.ArgumentParser(prog="compute_bop_results")
    parser.add_argument("test_config", help="m3-style cfg with [auto_pose] section")
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--dataset_name", required=True)
    parser.add_argument("--split", default="test")
    parser.add_argument("--targets", default="test_targets_bop19.json")
    parser.add_argument("--out_dir", default=".")
    parser.add_argument("--method", default="aae-torch")
    parser.add_argument("--detection_time", type=float, default=0.15,
                        help="assumed external detector time per image "
                             "(m3_template.cfg:21-22)")
    parser.add_argument("--gt_masks", choices=["auto", "on", "off"],
                        default="auto",
                        help="zero the background with the instance's "
                             "mask_visib before estimation, as the "
                             "reference BOP script does "
                             "(compute_bop_results_m3.py:162-166). auto: "
                             "mask when the file exists; on: require it; "
                             "off: plain bbox crops from the full image")
    args = parser.parse_args(argv)

    estimator = AePoseEstimator(args.test_config, device=device)

    with open(os.path.join(args.dataset_path, args.targets)) as fh:
        targets = json.load(fh)

    # group targets by (scene, image)
    by_image = defaultdict(list)
    for tgt in targets:
        by_image[(tgt["scene_id"], tgt["im_id"])].append(tgt)

    estimates = []
    loaders = {}
    for (scene_id, im_id), tgts in sorted(by_image.items()):
        if scene_id not in loaders:
            loaders[scene_id] = SceneLoader(
                scene_dir_for(args.dataset_path, scene_id)
            )
        loader = loaders[scene_id]
        img = loader.load_rgb(im_id)
        K = loader.cameras[im_id]["K"]
        H, W = img.shape[:2]

        boxes, gt_idcs = [], []
        for tgt in tgts:
            obj_id = tgt["obj_id"]
            for gi, gt in enumerate(loader.gt.get(im_id, [])):
                if gt.obj_id != obj_id:
                    continue
                bb = gt.bbox_visib or gt.bbox_obj
                if bb is None:
                    continue
                x, y, w, h = bb
                boxes.append(
                    BoundingBox(
                        xmin=max(x / W, 0.0), ymin=max(y / H, 0.0),
                        xmax=min((x + w) / W, 1.0), ymax=min((y + h) / H, 1.0),
                        classes={obj_id: 1.0},
                    )
                )
                gt_idcs.append(gi)

        t0 = time.time()
        masks = []
        if args.gt_masks != "off":
            masks = [loader.load_mask_visib(im_id, gi) for gi in gt_idcs]
            if args.gt_masks == "on" and any(m is None for m in masks):
                gi = gt_idcs[masks.index(None)]
                raise FileNotFoundError(
                    f"--gt_masks=on but no mask_visib for scene "
                    f"{scene_id} im {im_id} gt {gi}"
                )
        if any(m is not None for m in masks):
            # reference parity: one process() per instance on the
            # background-zeroed image (compute_bop_results_m3.py:162-176)
            poses = []
            for box, mask in zip(boxes, masks):
                im_in = (
                    img if mask is None
                    else img * mask[..., None].astype(img.dtype)
                )
                poses += estimator.process(
                    bboxes=[box], color_img=im_in, camK=K, mm=True
                )
        else:
            # no masks on disk (or --gt_masks=off): every crop comes from
            # the same full image, so keep the single batched dispatch
            poses = estimator.process(
                bboxes=boxes, color_img=img, camK=K, mm=True
            )
        aae_time = time.time() - t0
        img_time = args.detection_time + aae_time

        for pose in poses:
            estimates.append(
                BopEstimate(
                    scene_id=scene_id, im_id=im_id, obj_id=int(pose.name),
                    score=pose.quality, R=pose.trafo[:3, :3],
                    t=pose.trafo[:3, 3], time=img_time,
                )
            )

    path = write_bop_csv(
        estimates, args.out_dir, args.method, args.dataset_name, args.split
    )
    print(f"wrote {len(estimates)} estimates to {path}")
    return path


if __name__ == "__main__":
    main()
