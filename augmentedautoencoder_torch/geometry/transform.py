"""Rotation / quaternion utilities.

Fresh implementations of the standard rotation math the reference pulls from
Gohlke's transformations library (auto_pose/ae/pysixd_stuff/transform.py):
axis-angle rotation matrices, quaternion<->matrix conversion, uniform random
rotations (Shoemake's subgroup algorithm), and angular distance.

Quaternions use (w, x, y, z) ordering.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def unit_vector(v: Sequence[float]) -> np.ndarray:
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v)


def rotation_matrix(
    angle: float, direction: Sequence[float], point: Optional[Sequence[float]] = None
) -> np.ndarray:
    """4x4 homogeneous matrix rotating by `angle` around axis `direction`
    (through `point` if given). Matches Gohlke's convention
    (reference transform.py rotation_matrix)."""
    sina = math.sin(angle)
    cosa = math.cos(angle)
    d = unit_vector(direction[:3])

    R = np.diag([cosa, cosa, cosa])
    R += np.outer(d, d) * (1.0 - cosa)
    d_s = d * sina
    R += np.array(
        [
            [0.0, -d_s[2], d_s[1]],
            [d_s[2], 0.0, -d_s[0]],
            [-d_s[1], d_s[0], 0.0],
        ]
    )
    M = np.identity(4)
    M[:3, :3] = R
    if point is not None:
        point = np.asarray(point[:3], dtype=np.float64)
        M[:3, 3] = point - R.dot(point)
    return M


def quaternion_matrix(q: Sequence[float]) -> np.ndarray:
    """4x4 rotation matrix from quaternion (w, x, y, z)."""
    q = np.asarray(q, dtype=np.float64)
    n = np.dot(q, q)
    if n < 1e-12:
        return np.identity(4)
    q = q * math.sqrt(2.0 / n)
    q = np.outer(q, q)
    M = np.array(
        [
            [1.0 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0], 0.0],
            [q[1, 2] + q[3, 0], 1.0 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0], 0.0],
            [q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1.0 - q[1, 1] - q[2, 2], 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    return M


def quaternion_from_matrix(M: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) from a rotation matrix (3x3 or 4x4)."""
    R = np.asarray(M, dtype=np.float64)[:3, :3]
    t = np.trace(R)
    if t > 0.0:
        s = math.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = math.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = math.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = math.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def quaternions_from_matrices(Rs: np.ndarray) -> np.ndarray:
    """Batched quaternions (w, x, y, z) from rotation matrices (..., 3, 3).

    Vectorized Shepperd pivot selection: the four candidate constructions
    (one per largest diagonal term) are all evaluated, then the numerically
    safest is selected per matrix. Agrees with `quaternion_from_matrix` up
    to the overall quaternion sign.
    """
    R = np.asarray(Rs, dtype=np.float64)
    lead = R.shape[:-2]
    R = R.reshape(-1, 3, 3)
    r00, r01, r02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    r10, r11, r12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    r20, r21, r22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
    t = r00 + r11 + r22
    # 4*[w^2, x^2, y^2, z^2] — the argmax picks the pivot with the largest s
    pivots = np.stack([1.0 + t, 1.0 + 2 * r00 - t, 1.0 + 2 * r11 - t, 1.0 + 2 * r22 - t], axis=1)
    s = 2.0 * np.sqrt(np.maximum(pivots, 1e-12))  # (B, 4)
    cand = np.empty((R.shape[0], 4, 4))
    cand[:, 0] = np.stack([0.25 * s[:, 0], (r21 - r12) / s[:, 0], (r02 - r20) / s[:, 0], (r10 - r01) / s[:, 0]], axis=1)
    cand[:, 1] = np.stack([(r21 - r12) / s[:, 1], 0.25 * s[:, 1], (r01 + r10) / s[:, 1], (r02 + r20) / s[:, 1]], axis=1)
    cand[:, 2] = np.stack([(r02 - r20) / s[:, 2], (r01 + r10) / s[:, 2], 0.25 * s[:, 2], (r12 + r21) / s[:, 2]], axis=1)
    cand[:, 3] = np.stack([(r10 - r01) / s[:, 3], (r02 + r20) / s[:, 3], (r12 + r21) / s[:, 3], 0.25 * s[:, 3]], axis=1)
    q = cand[np.arange(R.shape[0]), np.argmax(pivots, axis=1)]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q.reshape(lead + (4,))


def matrices_from_quaternions(qs: np.ndarray) -> np.ndarray:
    """Batched rotation matrices (..., 3, 3) from quaternions (..., 4) in
    (w, x, y, z) order. Inputs are normalized internally."""
    q = np.asarray(qs, dtype=np.float64)
    lead = q.shape[:-1]
    q = q.reshape(-1, 4)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    M = np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
        ],
        axis=1,
    ).reshape(-1, 3, 3)
    return M.reshape(lead + (3, 3))


def random_quaternion(rand: Optional[np.ndarray] = None) -> np.ndarray:
    """Uniform random unit quaternion (w, x, y, z), Shoemake's method.

    Same construction as the reference's random_quaternion so that seeded
    random view generation is reproducible across the two codebases.
    """
    if rand is None:
        rand = np.random.rand(3)
    else:
        rand = np.asarray(rand, dtype=np.float64)
        assert rand.shape == (3,)
    r1 = math.sqrt(1.0 - rand[0])
    r2 = math.sqrt(rand[0])
    t1 = 2.0 * math.pi * rand[1]
    t2 = 2.0 * math.pi * rand[2]
    return np.array(
        [math.cos(t2) * r2, math.sin(t1) * r1, math.cos(t1) * r1, math.sin(t2) * r2]
    )


def random_rotation_matrix(rand: Optional[np.ndarray] = None) -> np.ndarray:
    """4x4 uniform random rotation matrix."""
    return quaternion_matrix(random_quaternion(rand))


def rotation_angle(R: np.ndarray) -> float:
    """Geodesic rotation angle of R in radians."""
    c = (np.trace(np.asarray(R)[:3, :3]) - 1.0) * 0.5
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def rotation_error(R1: np.ndarray, R2: np.ndarray) -> float:
    """Angular distance between two rotations in radians (the `re` metric)."""
    return rotation_angle(np.asarray(R1)[:3, :3].T @ np.asarray(R2)[:3, :3])


def rotz(angle: float) -> np.ndarray:
    """3x3 rotation about +z."""
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
