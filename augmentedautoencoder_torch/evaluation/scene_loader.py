"""Test-scene loaders: BOP (json) and legacy sixd (yaml) dataset layouts
(port of augmentedautoencoder_tpu/evaluation/scene_loader.py).

Replaces the reference's dependency on the external sixd_toolkit dataset
params (eval/eval_utils.py:137-165). Images are read by `utils.png.read_png`
(PIL), pixel for pixel what cv2.imread returns, since the card's machine
has no OpenCV; `yaml` is imported for the sixd layout only. Layouts
supported:

  BOP:   <root>/<split>/<scene:06d>/{rgb,depth}/<im:06d>.png
         + scene_gt.json, scene_camera.json [, scene_gt_info.json]
  sixd:  <root>/test_<cam>/<scene:02d>/{rgb,depth}/<im:04d>.png
         + gt.yml, info.yml

Ground truth is normalized to: {im_id: [ {obj_id, R (3,3), t (3,), bbox_obj
[x,y,w,h] or None, visib_fract or None} ]}; cameras to {im_id: {K (3,3),
depth_scale}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.png import read_png


@dataclasses.dataclass
class GTInstance:
    obj_id: int
    R: np.ndarray
    t: np.ndarray
    bbox_obj: Optional[List[float]] = None
    bbox_visib: Optional[List[float]] = None
    visib_fract: Optional[float] = None


class SceneLoader:
    """One scene's GT, camera, and images."""

    def __init__(self, scene_dir: str):
        self.scene_dir = scene_dir
        self.gt: Dict[int, List[GTInstance]] = {}
        self.cameras: Dict[int, Dict] = {}
        self._im_format = None
        if os.path.exists(os.path.join(scene_dir, "scene_gt.json")):
            self._load_bop()
        elif os.path.exists(os.path.join(scene_dir, "gt.yml")):
            self._load_sixd_yaml()
        else:
            raise FileNotFoundError(f"no scene_gt.json or gt.yml in {scene_dir}")

    # ------------------------------------------------------------- loading
    def _load_bop(self):
        with open(os.path.join(self.scene_dir, "scene_gt.json")) as fh:
            gt_raw = json.load(fh)
        with open(os.path.join(self.scene_dir, "scene_camera.json")) as fh:
            cam_raw = json.load(fh)
        info_path = os.path.join(self.scene_dir, "scene_gt_info.json")
        info_raw = {}
        if os.path.exists(info_path):
            with open(info_path) as fh:
                info_raw = json.load(fh)

        for im_id_str, insts in gt_raw.items():
            im_id = int(im_id_str)
            infos = info_raw.get(im_id_str, [{}] * len(insts))
            self.gt[im_id] = [
                GTInstance(
                    obj_id=int(inst["obj_id"]),
                    R=np.asarray(inst["cam_R_m2c"], np.float64).reshape(3, 3),
                    t=np.asarray(inst["cam_t_m2c"], np.float64).reshape(3),
                    bbox_obj=info.get("bbox_obj"),
                    bbox_visib=info.get("bbox_visib"),
                    visib_fract=info.get("visib_fract"),
                )
                for inst, info in zip(insts, infos)
            ]
        for im_id_str, cam in cam_raw.items():
            self.cameras[int(im_id_str)] = {
                "K": np.asarray(cam["cam_K"], np.float64).reshape(3, 3),
                "depth_scale": float(cam.get("depth_scale", 1.0)),
            }
        self._im_format = "{:06d}.png"

    def _load_sixd_yaml(self):
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"the legacy sixd scene layout (gt.yml, info.yml in {self.scene_dir}) needs PyYAML, "
                "which is not installed; the BOP json layout does not"
            ) from e

        with open(os.path.join(self.scene_dir, "gt.yml")) as fh:
            gt_raw = yaml.safe_load(fh)
        with open(os.path.join(self.scene_dir, "info.yml")) as fh:
            info_raw = yaml.safe_load(fh)
        for im_id, insts in gt_raw.items():
            self.gt[int(im_id)] = [
                GTInstance(
                    obj_id=int(inst["obj_id"]),
                    R=np.asarray(inst["cam_R_m2c"], np.float64).reshape(3, 3),
                    t=np.asarray(inst["cam_t_m2c"], np.float64).reshape(3),
                    bbox_obj=inst.get("obj_bb"),
                )
                for inst in insts
            ]
        for im_id, info in info_raw.items():
            self.cameras[int(im_id)] = {
                "K": np.asarray(info["cam_K"], np.float64).reshape(3, 3),
                "depth_scale": float(info.get("depth_scale", 1.0)),
            }
        self._im_format = "{:04d}.png"

    # ------------------------------------------------------------- access
    @property
    def im_ids(self) -> List[int]:
        return sorted(self.gt.keys())

    def load_rgb(self, im_id: int) -> np.ndarray:
        path = os.path.join(self.scene_dir, "rgb", self._im_format.format(im_id))
        return read_png(path)  # BGR, matching the pipeline convention

    def load_depth(self, im_id: int) -> np.ndarray:
        path = os.path.join(self.scene_dir, "depth", self._im_format.format(im_id))
        depth = read_png(path, unchanged=True)
        return depth.astype(np.float64) * self.cameras[im_id]["depth_scale"]

    def load_mask_visib(self, im_id: int, gt_idx: int) -> Optional[np.ndarray]:
        """Per-instance visible-pixel mask (BOP `mask_visib/<im>_<gt>.png`).

        `gt_idx` is the instance's position in the image's full scene_gt
        list (the BOP file-naming convention). Returns a bool HxW array,
        or None when the dataset ships no masks — callers fall back to
        unmasked crops. The reference's BOP script reads the same files
        and multiplies the image by mask/255
        (compute_bop_results_m3.py:162-166). A file that does not decode
        is None too, as cv2.imread's None is in the JAX package."""
        path = os.path.join(
            self.scene_dir, "mask_visib", f"{im_id:06d}_{gt_idx:06d}.png"
        )
        if not os.path.exists(path):
            return None
        try:
            m = read_png(path, unchanged=True)
        except (OSError, ValueError):
            return None
        if m.ndim == 3:
            m = m[..., 0]
        return m > 127


def scene_dir_for(dataset_path: str, scene_id: int, cam_type: str = "") -> str:
    """Resolve the scene dir in either layout."""
    bop = os.path.join(dataset_path, "test", f"{scene_id:06d}")
    if os.path.isdir(bop):
        return bop
    sixd = os.path.join(dataset_path, f"test_{cam_type}" if cam_type else "test", f"{scene_id:02d}")
    if os.path.isdir(sixd):
        return sixd
    raise FileNotFoundError(f"scene {scene_id} not found under {dataset_path}")
