"""Framework-neutral pose/detection interfaces (a copy of
augmentedautoencoder_tpu/pose/interfaces.py, whose package imports jax).

The equivalent of auto_pose/m3_interface/m3_interfaces.py:
`Roi3D`, `PoseEstimate`, `BoundingBox` (normalized 0-1 xyxy with a
class->score dict), plus the abstract pose-estimator / detector contracts.
Plain validated dataclasses instead of property boilerplate.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

_ROI_SHAPES = ("cube", "sphere", "cylinder")


@dataclasses.dataclass
class Roi3D:
    shape: str = "cube"
    pose: np.ndarray = dataclasses.field(default_factory=lambda: np.identity(4))
    scale: Sequence[float] = (1.0, 1.0, 1.0)
    is_world_coords: bool = True

    def __post_init__(self):
        assert self.shape in _ROI_SHAPES, self.shape
        self.pose = np.asarray(self.pose)
        assert self.pose.shape == (4, 4)
        assert len(self.scale) == 3


@dataclasses.dataclass
class PoseEstimate:
    name: str = "SLC"
    trafo: np.ndarray = dataclasses.field(default_factory=lambda: np.identity(4))
    quality: float = 1.0

    def __post_init__(self):
        self.trafo = np.asarray(self.trafo)
        assert self.trafo.shape == (4, 4)


@dataclasses.dataclass
class BoundingBox:
    """Normalized [0,1] xyxy box with per-class scores."""

    xmin: float = 0.0
    ymin: float = 0.0
    xmax: float = 1.0
    ymax: float = 1.0
    classes: Dict = dataclasses.field(default_factory=lambda: {"SLC": 1.0})

    def __post_init__(self):
        for v in (self.xmin, self.ymin, self.xmax, self.ymax):
            assert 0.0 <= v <= 1.0, f"normalized coords required, got {v}"

    @property
    def best_class(self):
        return max(self.classes, key=self.classes.get)

    def to_xywh(self, W: int, H: int) -> List[float]:
        return [
            self.xmin * W,
            self.ymin * H,
            (self.xmax - self.xmin) * W,
            (self.ymax - self.ymin) * H,
        ]


class PoseEstInterface(abc.ABC):
    """Contract of a 6D pose estimator (m3_interfaces.py:88-146)."""

    @staticmethod
    def get_params(config):
        """Load params from a .cfg / .yml path or pass a parser through."""
        if isinstance(config, str):
            if config.endswith((".yml", ".yaml")):
                import yaml

                with open(config) as fh:
                    return yaml.safe_load(fh)
            import configparser

            params = configparser.ConfigParser(inline_comment_prefixes="#")
            params.read(config)
            return params
        return config

    @abc.abstractmethod
    def set_parameter(self, string_name: str, string_val: str) -> None: ...

    @abc.abstractmethod
    def query_process_requirements(self) -> List[str]: ...

    @abc.abstractmethod
    def query_image_format(self) -> Dict: ...

    @abc.abstractmethod
    def process(
        self,
        bboxes: Sequence[BoundingBox] = (),
        color_img: Optional[np.ndarray] = None,
        depth_img: Optional[np.ndarray] = None,
        camK: Optional[np.ndarray] = None,
        camPose: Optional[np.ndarray] = None,
        rois3ds: Sequence[Roi3D] = (),
    ) -> List[PoseEstimate]: ...


class BoundingBoxDetector(abc.ABC):
    """Contract of a 2D detector feeding the pose estimator."""

    def __init__(self):
        self._clip_bb = None

    @abc.abstractmethod
    def process_raw(self, image) -> List[BoundingBox]: ...

    @abc.abstractmethod
    def preprocess_image(self, image, color_format_in, type_in): ...

    def process(self, image) -> List[BoundingBox]:
        if self._clip_bb is not None:
            bb = self._clip_bb
            h, w = image.shape[:2]
            image = image[
                int(h * bb["ymin"]) : int(h * bb["ymax"]),
                int(w * bb["xmin"]) : int(w * bb["xmax"]),
            ]
        return self.process_raw(image)
