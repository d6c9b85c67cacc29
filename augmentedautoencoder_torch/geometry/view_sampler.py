"""View-sphere sampling by icosahedron refinement (Hinterstoisser BMVC'08).

The point ORDER here is load-bearing: codebook row i corresponds to view
floor(i / num_cyclo) of this sampling, so the ordering must be bit-identical
to the reference implementation (auto_pose/ae/pysixd_stuff/view_sampler.py:19-188)
for checkpoint/codebook interoperability. The ordering is defined by:

  1. a fixed 12-vertex icosahedron and fixed face list,
  2. subdivision that appends edge midpoints in face-traversal order,
  3. a breadth-first sweep from the +z-topmost vertex, each frontier sorted
     by azimuth in [0, 2pi).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import transform


def calc_2d_bbox(xs: np.ndarray, ys: np.ndarray, im_size: Sequence[int]) -> List[float]:
    """Tight 2D bbox [x, y, w, h] around pixel coordinates, expanded by 1px
    and clamped to the image (reference view_sampler.py:10-15).

    im_size is (W, H).
    """
    box_lt = (max(xs.min() - 1, 0), max(ys.min() - 1, 0))
    box_rb = (min(xs.max() + 1, im_size[0] - 1), min(ys.max() + 1, im_size[1] - 1))
    return [box_lt[0], box_lt[1], box_rb[0] - box_lt[0], box_rb[1] - box_lt[1]]


def _icosahedron() -> Tuple[List[Tuple[float, float, float]], List[Tuple[int, int, int]]]:
    """The canonical icosahedron used by Hinterstoisser-style samplers.

    Vertex and face order fixed to preserve downstream point ordering.
    """
    a, b, c = 0.0, 1.0, (1.0 + math.sqrt(5.0)) / 2.0
    verts = [
        (-b, c, a), (b, c, a), (-b, -c, a), (b, -c, a),
        (a, -b, c), (a, b, c), (a, -b, -c), (a, b, -c),
        (c, a, -b), (c, a, b), (-c, a, -b), (-c, a, b),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    return verts, faces


def hinter_sampling(
    min_n_pts: int, radius: float = 1.0
) -> Tuple[np.ndarray, List[int]]:
    """Sample >= min_n_pts points on a sphere by icosahedron refinement.

    Returns (pts [N,3] on the sphere of given radius, per-point refinement
    level), in the azimuth-BFS order described in the module docstring.
    """
    verts, faces = _icosahedron()
    pts: List[List[float]] = [list(v) for v in verts]
    pts_level: List[int] = [0] * len(pts)

    level = 0
    while len(pts) < min_n_pts:
        level += 1
        midpoint_of: Dict[Tuple[int, int], int] = {}
        next_faces: List[Tuple[int, int, int]] = []
        for face in faces:
            corner_and_mid = list(face)  # [v0, v1, v2, m01, m12, m20]
            for i in range(3):
                edge = (face[i], face[(i + 1) % 3])
                edge = (min(edge), max(edge))
                mid_id = midpoint_of.get(edge)
                if mid_id is None:
                    mid_id = len(pts)
                    midpoint_of[edge] = mid_id
                    va = np.asarray(pts[edge[0]])
                    vb = np.asarray(pts[edge[1]])
                    pts.append((0.5 * (va + vb)).tolist())
                    pts_level.append(level)
                corner_and_mid.append(mid_id)
            v0, v1, v2, m01, m12, m20 = corner_and_mid
            next_faces += [(v0, m01, m20), (m01, v1, m12), (m01, m12, m20), (m20, m12, v2)]
        faces = next_faces

    arr = np.asarray(pts, dtype=np.float64)
    arr *= (radius / np.linalg.norm(arr, axis=1))[:, None]

    # adjacency from the final face set
    neighbors: Dict[int, set] = {}
    for face in faces:
        for i in range(3):
            neighbors.setdefault(face[i], set()).add(face[(i + 1) % 3])
            neighbors[face[i]].add(face[(i + 2) % 3])

    def azimuth(i: int) -> float:
        two_pi = 2.0 * math.pi
        return (math.atan2(arr[i, 1], arr[i, 0]) + two_pi) % two_pi

    # BFS from the topmost point, each frontier sorted by azimuth
    order: List[int] = []
    done = [False] * arr.shape[0]
    frontier = [int(np.argmax(arr[:, 2]))]
    while len(order) != arr.shape[0]:
        frontier = sorted(frontier, key=azimuth)
        next_ids: List[int] = []
        for pid in frontier:
            order.append(pid)
            done[pid] = True
            next_ids += list(neighbors[pid])
        frontier = [i for i in set(next_ids) if not done[i]]

    order_arr = np.asarray(order)
    arr = arr[order_arr]
    pts_level = [pts_level[i] for i in order]
    return arr, pts_level


def sample_views(
    min_n_views: int,
    radius: float = 1.0,
    azimuth_range: Tuple[float, float] = (0.0, 2.0 * math.pi),
    elev_range: Tuple[float, float] = (-0.5 * math.pi, 0.5 * math.pi),
) -> Tuple[List[dict], List[int]]:
    """Sample camera views on a sphere looking at the origin.

    Each view is {'R': 3x3, 't': 3x1} in the OpenCV camera convention
    (gluLookAt-style basis followed by a pi x-flip, reference
    view_sampler.py:162-186). Views outside the azimuth/elev ranges are
    dropped after sampling.
    """
    pts, pts_level = hinter_sampling(min_n_views, radius=radius)

    flip_x = transform.rotation_matrix(math.pi, [1, 0, 0])[:3, :3]

    views = []
    for pt in pts:
        az = math.atan2(pt[1], pt[0])
        if az < 0:
            az += 2.0 * math.pi
        r_full = np.linalg.norm(pt)
        r_xy = np.linalg.norm([pt[0], pt[1], 0.0])
        elev = math.acos(min(max(r_xy / r_full, -1.0), 1.0))
        if pt[2] < 0:
            elev = -elev

        if not (
            azimuth_range[0] <= az <= azimuth_range[1]
            and elev_range[0] <= elev <= elev_range[1]
        ):
            continue

        fwd = -np.asarray(pt, dtype=np.float64)
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        side = np.cross(fwd, up)
        if np.count_nonzero(side) == 0:
            side = np.array([1.0, 0.0, 0.0])  # looking along +-z
        side /= np.linalg.norm(side)
        up = np.cross(side, fwd)
        R_gl = np.stack([side, up, -fwd])
        R = flip_x.dot(R_gl)
        t = -R.dot(np.asarray(pt, dtype=np.float64).reshape(3, 1))
        views.append({"R": R, "t": t})

    return views, pts_level


def viewsphere_rotations(
    min_n_views: int, num_cyclo: int, radius: float = 1.0
) -> np.ndarray:
    """The full embedding view sphere: every sampled view combined with
    num_cyclo in-plane rotations (reference dataset.py:39-58).

    Returns [n_views * num_cyclo, 3, 3]; row ordering is codebook ordering.
    """
    views, _ = sample_views(min_n_views, radius)
    Rs = np.empty((len(views) * num_cyclo, 3, 3))
    i = 0
    for view in views:
        for cyclo in np.linspace(0.0, 2.0 * np.pi, num_cyclo):
            Rs[i] = transform.rotz(-cyclo).dot(view["R"])
            i += 1
    return Rs
