"""Procedural meshes for tests and the chip smoke test, no assets needed
(copy of augmentedautoencoder_tpu/renderer/procedural.py)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .mesh import Mesh, compute_vertex_normals


def make_cube(size: float = 100.0, colored: bool = True) -> Mesh:
    """Axis-aligned cube centered at origin, optional per-vertex RGB coding
    position — orientation-revealing for codebook tests."""
    s = size / 2.0
    corners = np.array(
        [[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
        dtype=np.float64,
    )
    # 12 triangles, outward winding (winding irrelevant: no culling)
    quads = [
        (0, 1, 3, 2), (4, 6, 7, 5),  # x- x+
        (0, 4, 5, 1), (2, 3, 7, 6),  # y- y+
        (0, 2, 6, 4), (1, 5, 7, 3),  # z- z+
    ]
    # duplicate vertices per face for flat normals
    verts, faces = [], []
    for q in quads:
        base = len(verts)
        verts += [corners[i] for i in q]
        faces += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    v = np.asarray(verts)
    f = np.asarray(faces, dtype=np.int32)
    colors = (255.0 * (v / size + 0.5)) if colored else None
    return Mesh(vertices=v, normals=compute_vertex_normals(v, f), faces=f, colors=colors)


def make_icosphere(subdivisions: int = 2, radius: float = 60.0, colored: bool = True) -> Mesh:
    """Icosphere by midpoint subdivision; vertex colors encode direction."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [np.asarray(v, dtype=np.float64) / np.linalg.norm(v) for v in verts]

    for _ in range(subdivisions):
        mid = {}
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = new_faces

    v = np.asarray(verts) * radius
    f = np.asarray(faces, dtype=np.int32)
    normals = np.asarray(verts)  # unit sphere: normal == direction
    colors = 255.0 * 0.5 * (np.asarray(verts) + 1.0) if colored else None
    return Mesh(vertices=v, normals=normals, faces=f, colors=colors)


def make_textured_asymmetric(
    subdivisions: int = 5, radius: float = 60.0, seed: Optional[int] = None
) -> Mesh:
    """Asymmetric, high-frequency-textured object for quality evaluation —
    the regime of the paper's real objects (textured, orientation-
    unambiguous), unlike the near-symmetric bumpy sphere.

    Geometry: icosphere deformed by smooth low-order lobes with no symmetry
    plane. Texture: per-vertex 3D checker with direction-dependent palette
    plus a bright marker patch on one octant (kills any residual ambiguity).
    Fully deterministic. With `seed`, the lobes' frequencies and phases
    are drawn from np.random.RandomState(seed) around the default ones, so
    each seed gives another object of the same kind (one mesh a seed, as
    for the objects of a multi-path model); without it, the default mesh.
    """
    base = make_icosphere(subdivisions, 1.0, colored=False)
    d = base.vertices / np.linalg.norm(base.vertices, axis=1, keepdims=True)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]

    # frequencies and phases of the lobes, each drawn around its default with a seed
    f = np.array([2.1, 0.5, 1.7, -0.3, 3.3, 1.0, 1.3, 0.7, 2.7, 2.0])
    if seed is not None:
        f = f + np.random.RandomState(seed).uniform(-0.8, 0.8, f.shape)
    # smooth asymmetric radial field, strictly positive
    r = 1.0 + (
        0.28 * np.sin(f[0] * x + f[1]) * np.cos(f[2] * y + f[3])
        + 0.22 * np.sin(f[4] * z + f[5]) * np.cos(f[6] * x + f[7])
        + 0.15 * np.sin(f[8] * y + f[9])
    )
    v = d * (radius * r)[:, None]
    f = base.faces

    # high-contrast 3D checker in object coordinates (~12 mm cells)
    cell = radius / 5.0
    checker = (
        np.floor(v[:, 0] / cell) + np.floor(v[:, 1] / cell) + np.floor(v[:, 2] / cell)
    ) % 2
    pal_a = np.stack([40 + 180 * (x * 0.5 + 0.5), 60 + 150 * (y * 0.5 + 0.5),
                      230 - 170 * (z * 0.5 + 0.5)], axis=1)
    pal_b = np.stack([230 - 170 * (y * 0.5 + 0.5), 40 + 180 * (z * 0.5 + 0.5),
                      60 + 150 * (x * 0.5 + 0.5)], axis=1)
    colors = np.where(checker[:, None] > 0, pal_a, pal_b)
    marker = (x > 0.55) & (y > 0.35) & (z > 0.2)
    colors[marker] = [255.0, 255.0, 0.0]

    return Mesh(
        vertices=v,
        normals=compute_vertex_normals(v, f),
        faces=f,
        colors=np.clip(colors, 0, 255),
    )


def save_ply(mesh: Mesh, path: str) -> None:
    """Write an ascii PLY (round-trip partner for mesh.load_ply)."""
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(mesh.vertices)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        fh.write("property float nx\nproperty float ny\nproperty float nz\n")
        has_colors = mesh.colors is not None
        if has_colors:
            fh.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        fh.write(f"element face {len(mesh.faces)}\n")
        fh.write("property list uchar int vertex_indices\nend_header\n")
        for i in range(len(mesh.vertices)):
            row = list(mesh.vertices[i]) + list(mesh.normals[i])
            line = " ".join(f"{x:.6f}" for x in row)
            if has_colors:
                line += " " + " ".join(str(int(c)) for c in mesh.colors[i])
            fh.write(line + "\n")
        for f in mesh.faces:
            fh.write(f"3 {f[0]} {f[1]} {f[2]}\n")
