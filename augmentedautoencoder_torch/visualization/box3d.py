"""3D bounding-box overlay (port of augmentedautoencoder_tpu/visualization/
box3d.py): the model's axis-aligned box projected through a pose and its 12
edges drawn by `utils/draw.line`, OpenCV's pixels without OpenCV."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..geometry.misc import project_pts
from ..utils import draw

# cube corners as (min/max selector) triples; edges as corner index pairs
_CORNERS = np.array(
    [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], dtype=np.int64
)
_EDGES = [
    (0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
    (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7),
]


def box3d_corners(vert_min: Sequence[float], vert_max: Sequence[float]) -> np.ndarray:
    """(8, 3) corners of the axis-aligned model-space box."""
    lo = np.asarray(vert_min, dtype=np.float64)
    hi = np.asarray(vert_max, dtype=np.float64)
    return np.where(_CORNERS.astype(bool), hi, lo)


def draw_box3d(
    image: np.ndarray,
    vert_min: Sequence[float],
    vert_max: Sequence[float],
    K: np.ndarray,
    R: np.ndarray,
    t: np.ndarray,
    color: Tuple[int, int, int] = (0, 255, 0),
    thickness: int = 2,
) -> np.ndarray:
    """Project the model box through pose (R, t) and draw its 12 edges."""
    out = image.copy()
    corners = box3d_corners(vert_min, vert_max)
    pix = project_pts(corners, np.asarray(K), np.asarray(R), np.asarray(t))
    pix = np.round(pix).astype(int)
    for a, b in _EDGES:
        draw.line(out, tuple(pix[a]), tuple(pix[b]), color, thickness)
    return out


def draw_box3d_for_mesh(image, mesh, K, R, t, **kw) -> np.ndarray:
    return draw_box3d(
        image, mesh.vertices.min(axis=0), mesh.vertices.max(axis=0), K, R, t, **kw
    )
