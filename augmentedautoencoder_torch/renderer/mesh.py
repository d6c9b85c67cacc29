"""Mesh loading: PLY (ascii + binary) and OBJ, with md5-keyed vertex caches
and an LOD decimation (port of augmentedautoencoder_tpu/renderer/mesh.py).

The reference loads `reconst` models with a python PLY parser and `cad`
models via pyassimp, caching the unpacked vertex arrays as md5-hashed files
(auto_pose/meshrenderer/gl_utils/geometry.py:17-41, inout.py:8-154); PLY
and OBJ are parsed natively here, with no assimp. The `.npz` cache has the
JAX package's key and fields, so either package reads the other's; the port
writes it atomically (a temporary file, then a rename), so a reader never
sees a half-written cache.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import struct
import threading
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float64
    normals: np.ndarray  # (V, 3) float64, unit
    faces: np.ndarray  # (F, 3) int32
    colors: Optional[np.ndarray] = None  # (V, 3) float64 in [0, 255] or None

    @property
    def diameter(self) -> float:
        """Max pairwise extent approximation (bbox diagonal)."""
        lo = self.vertices.min(axis=0)
        hi = self.vertices.max(axis=0)
        return float(np.linalg.norm(hi - lo))


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (reference geometry.py:68-82 recomputes
    normals on the CPU the same way)."""
    v = vertices
    f = faces
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    normals = np.zeros_like(v)
    for i in range(3):
        np.add.at(normals, f[:, i], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    lens[lens == 0] = 1.0
    return normals / lens


# ---------------------------------------------------------------- PLY

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str) -> Mesh:
    """Parse ascii / binary-LE / binary-BE PLY with arbitrary property order."""
    with open(path, "rb") as fh:
        # ---- header
        magic = fh.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # [(name, count, [(prop_name, type) or ('list', idx_t, cnt_t, name)])]
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens or tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append(("list", tokens[2], tokens[3], tokens[4]))
                else:
                    elements[-1][2].append((tokens[2], tokens[1]))
            elif tokens[0] == "end_header":
                break

        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
        vertices = normals = colors = None
        faces = []

        for name, count, props in elements:
            if name == "vertex":
                prop_names = [p[0] for p in props]
                if fmt == "ascii":
                    rows = np.loadtxt(
                        [fh.readline() for _ in range(count)], dtype=np.float64, ndmin=2
                    )
                else:
                    fmt_str = endian + "".join(_PLY_TYPES[p[1]][0] for p in props)
                    size = struct.calcsize(fmt_str)
                    raw = fh.read(size * count)
                    rows = np.array(
                        [struct.unpack_from(fmt_str, raw, i * size) for i in range(count)],
                        dtype=np.float64,
                    )
                cols = {n: rows[:, i] for i, n in enumerate(prop_names)}
                vertices = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
                if all(k in cols for k in ("nx", "ny", "nz")):
                    normals = np.stack([cols["nx"], cols["ny"], cols["nz"]], axis=1)
                if all(k in cols for k in ("red", "green", "blue")):
                    colors = np.stack([cols["red"], cols["green"], cols["blue"]], axis=1)
            elif name == "face":
                for _ in range(count):
                    if fmt == "ascii":
                        vals = [int(v) for v in fh.readline().split()]
                        n, idx = vals[0], vals[1:]
                    else:
                        cnt_t = _PLY_TYPES[props[0][1]]
                        idx_t = _PLY_TYPES[props[0][2]]
                        n = struct.unpack(endian + cnt_t[0], fh.read(cnt_t[1]))[0]
                        idx = struct.unpack(
                            endian + idx_t[0] * n, fh.read(idx_t[1] * n)
                        )
                        # trailing non-list props (rare) are skipped for other
                        # elements; faces with extras are not supported
                    for k in range(1, n - 1):  # fan-triangulate
                        faces.append((idx[0], idx[k], idx[k + 1]))
            else:
                # skip unknown element payload (ascii only — binary unknown
                # elements after faces are not expected in sixd models)
                if fmt == "ascii":
                    for _ in range(count):
                        fh.readline()

    if vertices is None:
        raise ValueError(f"{path}: no vertex element")
    faces_arr = np.asarray(faces, dtype=np.int32)
    if normals is None:
        normals = compute_vertex_normals(vertices, faces_arr)
    return Mesh(vertices=vertices, normals=normals, faces=faces_arr, colors=colors)


# ---------------------------------------------------------------- OBJ

def load_obj(path: str) -> Mesh:
    vertices, faces, colors = [], [], []
    with open(path) as fh:
        for line in fh:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vertices.append([float(x) for x in t[1:4]])
                if len(t) >= 7:  # vertex-color extension
                    colors.append([float(x) * 255.0 for x in t[4:7]])
            elif t[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in t[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(vertices, dtype=np.float64)
    f = np.asarray(faces, dtype=np.int32)
    c = np.asarray(colors, dtype=np.float64) if len(colors) == len(vertices) else None
    return Mesh(vertices=v, normals=compute_vertex_normals(v, f), faces=f, colors=c)


# ---------------------------------------------------------------- cache

def load_mesh(
    path: str,
    vertex_scale: float = 1.0,
    cache_dir: Optional[str] = None,
    recalculate_normals: bool = False,
) -> Mesh:
    """Load a .ply or .obj mesh, vertices scaled by `vertex_scale`, through
    an optional md5-keyed `.npz` cache in `cache_dir` (the JAX package's key:
    md5 of path + str(vertex_scale) + str(recalculate_normals))."""
    cache_file = None
    if cache_dir:
        key = hashlib.md5(
            (path + str(vertex_scale) + str(recalculate_normals)).encode()
        ).hexdigest()
        cache_file = os.path.join(cache_dir, key + ".npz")
        if os.path.exists(cache_file):
            with np.load(cache_file) as data:
                return Mesh(
                    vertices=data["vertices"],
                    normals=data["normals"],
                    faces=data["faces"],
                    colors=data["colors"] if data["has_colors"] else None,
                )

    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        mesh = load_ply(path)
    elif ext == ".obj":
        mesh = load_obj(path)
    else:
        raise ValueError(f"unsupported mesh format: {path}")

    mesh.vertices = mesh.vertices * vertex_scale
    if recalculate_normals:
        mesh.normals = compute_vertex_normals(mesh.vertices, mesh.faces)

    if cache_file:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{cache_file}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as fh:  # a file object: np.savez adds no suffix
            np.savez(
                fh,
                vertices=mesh.vertices,
                normals=mesh.normals,
                faces=mesh.faces,
                colors=mesh.colors if mesh.colors is not None else np.zeros((0, 3)),
                has_colors=mesh.colors is not None,
            )
        os.replace(tmp, cache_file)  # atomic: a concurrent reader sees all or nothing
    return mesh


# ---------------------------------------------------------------- LOD

def decimate_mesh(mesh: Mesh, target_faces: int) -> Mesh:
    """Uniform-grid vertex-clustering decimation (the JAX package's LOD for
    its offline renders; the reference has no LOD path).

    The codebook embed renders 92k views of a mesh whose triangles are
    mostly sub-pixel at render scale, so rasterization cost is per-face
    setup; clustering vertices on a regular grid and collapsing degenerate
    faces cuts the face count with no visible change at that resolution.

    Deterministic: new vertices are the mean of their cluster (colors
    averaged the same way, normals recomputed area-weighted). A mesh with
    <= target_faces faces is returned unchanged.
    """
    if len(mesh.faces) <= target_faces:
        return mesh

    lo = mesh.vertices.min(axis=0)
    hi = mesh.vertices.max(axis=0)
    diag = float(np.linalg.norm(hi - lo))
    if diag == 0.0:
        return mesh

    # bisect the cluster-cell size: face count decreases monotonically as
    # cells grow; aim for the largest count <= target
    cell_lo, cell_hi = diag / 4096.0, diag / 2.0
    best = None
    for _ in range(24):
        cell = (cell_lo * cell_hi) ** 0.5
        out = _cluster_collapse(mesh, cell)
        n = len(out.faces)
        if n > target_faces:
            cell_lo = cell
        else:
            best = out
            cell_hi = cell
        if best is not None and 0.7 * target_faces <= len(best.faces) <= target_faces:
            break
    return best if best is not None else _cluster_collapse(mesh, cell_hi)


def _cluster_collapse(mesh: Mesh, cell: float) -> Mesh:
    v = mesh.vertices
    lo = v.min(axis=0)
    key = np.floor((v - lo) / cell).astype(np.int64)
    # dense cluster ids (deterministic; exact 3-column unique, no hashing)
    _, first_idx, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    inverse = inverse.reshape(-1)
    n_clusters = len(first_idx)

    # new vertex = cluster mean (same for colors)
    counts = np.bincount(inverse, minlength=n_clusters).astype(np.float64)
    new_v = np.zeros((n_clusters, 3))
    for a in range(3):
        new_v[:, a] = np.bincount(inverse, weights=v[:, a], minlength=n_clusters)
    new_v /= counts[:, None]
    new_c = None
    if mesh.colors is not None:
        new_c = np.zeros((n_clusters, 3))
        for a in range(3):
            new_c[:, a] = np.bincount(
                inverse, weights=mesh.colors[:, a], minlength=n_clusters
            )
        new_c /= counts[:, None]

    # remap faces; drop degenerate (collapsed) and duplicate ones
    f = inverse[mesh.faces]
    keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    f = f[keep]
    # dedupe ignoring rotation (same oriented triangle listed from any vertex)
    rolled = np.stack([f, f[:, [1, 2, 0]], f[:, [2, 0, 1]]], axis=1)
    canon = rolled[np.arange(len(f)), rolled[:, :, 0].argmin(axis=1)]
    _, uniq_idx = np.unique(canon, axis=0, return_index=True)
    f = f[np.sort(uniq_idx)].astype(np.int32)

    return Mesh(
        vertices=new_v,
        normals=compute_vertex_normals(new_v, f),
        faces=f,
        colors=new_c,
    )
