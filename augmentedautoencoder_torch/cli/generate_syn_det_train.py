"""`python -m augmentedautoencoder_torch.cli.generate_syn_det_train` -- fully
synthetic cluttered-scene detector training data (port of
augmentedautoencoder_tpu/cli/generate_syn_det_train.py; reference
detection_utils/generate_syn_det_train.py).

Renders N multi-object scenes with random placement, light and background
on the host (`renderer/scenerenderer`) and writes PNG images
(`utils/png.write_png`) and Pascal-VOC XML annotations. The global
`np.random` drives every draw, as in the JAX package: seed it before
`main` for a repeatable set.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..config import safe_eval
from ..renderer.scenerenderer import SceneRenderer
from ..renderer.write_xml import write_voc_xml
from ..utils.png import write_png


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns the output directories and each scene's objects."""
    parser = argparse.ArgumentParser(prog="generate_syn_det_train")
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--model_paths", nargs="+", required=True)
    parser.add_argument("--obj_ids", nargs="+", type=int, default=None)
    parser.add_argument("--vocdevkit_path", required=True,
                        help="folder of background .jpg/.png images")
    parser.add_argument("--num_scenes", type=int, default=1000)
    parser.add_argument("--width", type=int, default=720)
    parser.add_argument("--height", type=int, default=540)
    parser.add_argument("--K", default="[1075.65, 0, 360, 0, 1073.90, 270, 0, 0, 1]")
    parser.add_argument("--vertex_scale", type=float, default=1.0)
    parser.add_argument("--min_objects", type=int, default=3)
    parser.add_argument("--max_objects", type=int, default=8)
    parser.add_argument("--radius", type=float, default=650.0)
    parser.add_argument("--model_type", default="reconst")
    args = parser.parse_args(argv)

    img_dir = os.path.join(args.output_path, "images")
    ann_dir = os.path.join(args.output_path, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    K = np.asarray(safe_eval(args.K), np.float64).reshape(3, 3)
    sr = SceneRenderer(
        args.model_paths,
        vertex_tmp_store_folder=args.output_path,
        vertex_scale=args.vertex_scale,
        width=args.width,
        height=args.height,
        K=K,
        augmenters=None,
        vocdevkit_path=args.vocdevkit_path,
        min_num_objects_per_scene=args.min_objects,
        max_num_objects_per_scene=args.max_objects,
        radius=args.radius,
        obj_ids=args.obj_ids,
        model_type=args.model_type,
    )

    scenes = []
    for i in range(args.num_scenes):
        bgr, obj_info = sr.render()
        name = f"syn_{i:06d}"
        write_png(os.path.join(img_dir, name + ".png"), bgr)
        write_voc_xml(
            os.path.join(ann_dir, name + ".xml"), name + ".png",
            args.width, args.height, obj_info,
        )
        scenes.append(obj_info)
        if i % 100 == 0:
            print(f"{i}/{args.num_scenes} scenes")
    print(f"wrote {args.num_scenes} scenes to {args.output_path}")
    return {"images": img_dir, "annotations": ann_dir, "scenes": scenes}


if __name__ == "__main__":
    main()
