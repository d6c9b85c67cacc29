"""`python -m augmentedautoencoder_torch.cli.generate_sixd_train` -- detector
training data from REAL dataset crops (port of augmentedautoencoder_tpu/cli/
generate_sixd_train.py; reference detection_utils/generate_sixd_train.py).

Cuts object crops (by GT bbox) out of sixd/BOP train scenes, read through
`evaluation/scene_loader`, and pastes several of them onto random
backgrounds, tracking occlusion so heavily covered instances are dropped
from the annotations; writes PNG images (`utils/png.write_png`) and VOC XML.
Backgrounds are decoded with PIL and resized by
`pose.estimator.resize_linear_u8` (cv2.imread and cv2.resize's pixels).
"""

from __future__ import annotations

import argparse
import glob
import os
import random
from typing import Dict, Optional, Sequence

import numpy as np

from ..data.dataset import decode_bgr
from ..evaluation.scene_loader import SceneLoader, scene_dir_for
from ..pose.estimator import resize_linear_u8
from ..renderer.write_xml import write_voc_xml
from ..utils.png import write_png


def collect_crops(dataset_path: str, scene_ids, max_per_scene: int = 200):
    """[(crop bgr, mask bool, obj_id)] from GT-bboxed scene regions."""
    crops = []
    for scene_id in scene_ids:
        loader = SceneLoader(scene_dir_for(dataset_path, scene_id))
        for im_id in loader.im_ids[:max_per_scene]:
            img = loader.load_rgb(im_id)
            try:
                depth = loader.load_depth(im_id)
            except FileNotFoundError:
                depth = None
            for gt in loader.gt[im_id]:
                bb = gt.bbox_visib or gt.bbox_obj
                if bb is None:
                    continue
                x, y, w, h = [int(v) for v in bb]
                if w < 8 or h < 8:
                    continue
                crop = img[y : y + h, x : x + w]
                if depth is not None:
                    mask = depth[y : y + h, x : x + w] > 0
                else:
                    mask = np.ones((h, w), bool)
                crops.append((crop, mask, gt.obj_id))
    return crops


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns the output directories and each image's kept objects."""
    parser = argparse.ArgumentParser(prog="generate_sixd_train")
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--scenes", nargs="+", type=int, required=True)
    parser.add_argument("--vocdevkit_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--num_images", type=int, default=1000)
    parser.add_argument("--width", type=int, default=720)
    parser.add_argument("--height", type=int, default=540)
    parser.add_argument("--min_objects", type=int, default=3)
    parser.add_argument("--max_objects", type=int, default=8)
    parser.add_argument("--min_visib", type=float, default=0.5,
                        help="drop annotations with less visible fraction")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    rng = random.Random(args.seed)
    np.random.seed(args.seed)

    crops = collect_crops(args.dataset_path, args.scenes)
    if not crops:
        raise SystemExit("no GT crops found — do the scenes have bboxes?")
    print(f"collected {len(crops)} object crops")

    voc_imgs = sorted(
        glob.glob(os.path.join(args.vocdevkit_path, "*.jpg"))
        + glob.glob(os.path.join(args.vocdevkit_path, "*.png"))
    )
    img_dir = os.path.join(args.output_path, "images")
    ann_dir = os.path.join(args.output_path, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    W, H = args.width, args.height
    images = []
    for i in range(args.num_images):
        canvas = resize_linear_u8(decode_bgr(rng.choice(voc_imgs)), (W, H))
        coverage = np.full((H, W), -1, np.int32)  # which instance owns a px

        n = rng.randint(args.min_objects, args.max_objects)
        placed = []
        for k in range(n):
            crop, mask, obj_id = crops[rng.randrange(len(crops))]
            ch, cw = crop.shape[:2]
            if ch >= H or cw >= W:
                continue
            x0 = rng.randrange(0, W - cw)
            y0 = rng.randrange(0, H - ch)
            region = canvas[y0 : y0 + ch, x0 : x0 + cw]
            region[mask] = crop[mask]
            coverage[y0 : y0 + ch, x0 : x0 + cw][mask] = len(placed)
            placed.append(
                {"id": obj_id, "bb": [x0, y0, x0 + cw, y0 + ch], "pix": int(mask.sum())}
            )

        # visibility bookkeeping: later pastes occlude earlier ones
        objects = []
        for idx, info in enumerate(placed):
            visible = int((coverage == idx).sum())
            if info["pix"] and visible / info["pix"] >= args.min_visib:
                objects.append({"id": info["id"], "bb": info["bb"]})

        name = f"sixd_{i:06d}"
        write_png(os.path.join(img_dir, name + ".png"), canvas)
        write_voc_xml(os.path.join(ann_dir, name + ".xml"), name + ".png", W, H, objects)
        images.append(objects)
        if i % 100 == 0:
            print(f"{i}/{args.num_images}")
    print(f"wrote {args.num_images} composite images to {args.output_path}")
    return {"images": img_dir, "annotations": ann_dir, "objects": images}


if __name__ == "__main__":
    main()
