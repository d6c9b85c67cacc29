"""Reference software rasterizer (numpy) with GL-matched semantics (copy of
augmentedautoencoder_tpu/renderer/raster_numpy.py).

Replicates what the reference's GL pipeline computes end to end
(auto_pose/meshrenderer/meshrenderer_phong.py:101-168 +
shader/depth_shader_phong.{vs,frag} + gl_utils/camera.py:86-166):

  * OpenCV pinhole projection u = (fx x + s y)/z + cx, v = fy y/z + cy
    (the GL ortho/persp/z-flip/flipud chain nets out to exactly this)
  * z-buffer on eye-space z (z forward, in model units), near/far clipped
  * Gouraud-interpolated Phong evaluated per fragment: positional light at
    `light_pos` in GL eye coords, weights (ambient, diffuse, specular),
    specular without shininess exponent, clamp to [0,1]
  * outputs: BGR uint8 (H,W,3) + eye-space depth float32 (H,W), background 0
  * perspective-correct attribute interpolation (GL default for varyings)

The C++ backend (native/rasterizer.cpp) mirrors this file; tests assert the
two agree; the port's CPU tests render with it, and `render_normals`
draws the normals image with it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .mesh import Mesh


def phong_vertex_attributes(
    mesh: Mesh,
    R: np.ndarray,
    t: np.ndarray,
    light_pos: np.ndarray,
):
    """Per-vertex eye-space quantities, in the shader's GL-eye convention
    (x right, y down, z backward: gl = (x_cv, y_cv, -z_cv))."""
    p_cv = mesh.vertices @ R.T + t.reshape(1, 3)
    p_gl = p_cv * np.array([1.0, 1.0, -1.0])
    n_gl = (mesh.normals @ R.T) * np.array([1.0, 1.0, -1.0])
    n_gl = n_gl / np.maximum(np.linalg.norm(n_gl, axis=1, keepdims=True), 1e-12)
    L = light_pos.reshape(1, 3) - p_gl
    L = L / np.maximum(np.linalg.norm(L, axis=1, keepdims=True), 1e-12)
    view = -p_gl
    if mesh.colors is not None:
        color = mesh.colors / 255.0
    else:
        # gray 160 fallback for colorless meshes (meshrenderer_phong.py:50)
        color = np.full((len(mesh.vertices), 3), 160.0 / 255.0)
    return p_cv, n_gl, L, view, color


def shade(normal, light, view, color, ambient, diffuse, specular):
    """The fragment shader (depth_shader_phong.frag:20-36), vectorized.

    All inputs (..., 3); interpolated vectors are re-normalized here.
    """

    def _norm(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)

    N, L, V = _norm(normal), _norm(light), _norm(view)
    ndotl = np.maximum((N * L).sum(-1, keepdims=True), 0.0)
    refl = 2.0 * (N * L).sum(-1, keepdims=True) * N - L
    rdotv = np.maximum((refl * V).sum(-1, keepdims=True), 0.0)
    rgb = ambient * color + diffuse * ndotl * color + specular * rdotv * color
    return np.clip(rgb, 0.0, 1.0)


def render_mesh(
    mesh: Mesh,
    W: int,
    H: int,
    K: np.ndarray,
    R: np.ndarray,
    t: np.ndarray,
    near: float,
    far: float,
    light_pos: np.ndarray,
    ambient: float,
    diffuse: float,
    specular: float,
    return_normals: bool = False,
) -> Tuple[np.ndarray, ...]:
    """Rasterize one mesh; returns (bgr uint8 (H,W,3), depth float32 (H,W)).

    With return_normals=True additionally returns the camera-space normal
    image encoded as (n*0.5+0.5) float32 (H,W,3) — the reference's
    meshrenderer_phong_normals third attachment
    (depth_shader_phong.frag:36)."""
    K = np.asarray(K, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64).reshape(3)
    light_pos = np.asarray(light_pos, dtype=np.float64)

    p_cv, n_gl, l_gl, v_gl, color = phong_vertex_attributes(mesh, R, t, light_pos)
    z = p_cv[:, 2]

    depth_buf = np.full((H, W), np.inf, dtype=np.float64)
    color_buf = np.zeros((H, W, 3), dtype=np.float64)
    normal_buf = np.zeros((H, W, 3), dtype=np.float64) if return_normals else None

    valid_z = z > 1e-9
    u = np.where(valid_z, (K[0, 0] * p_cv[:, 0] + K[0, 1] * p_cv[:, 1]) / np.where(valid_z, z, 1.0) + K[0, 2], 0.0)
    v = np.where(valid_z, K[1, 1] * p_cv[:, 1] / np.where(valid_z, z, 1.0) + K[1, 2], 0.0)

    inv_z = np.where(valid_z, 1.0 / np.where(valid_z, z, 1.0), 0.0)

    for f in mesh.faces:
        i0, i1, i2 = int(f[0]), int(f[1]), int(f[2])
        if not (valid_z[i0] and valid_z[i1] and valid_z[i2]):
            continue  # behind-camera triangles are skipped (no near slicing)
        xs = np.array([u[i0], u[i1], u[i2]])
        ys = np.array([v[i0], v[i1], v[i2]])

        # screen bbox -> candidate pixel centers
        x_min = max(int(np.floor(xs.min() - 0.5)), 0)
        x_max = min(int(np.ceil(xs.max() - 0.5)), W - 1)
        y_min = max(int(np.floor(ys.min() - 0.5)), 0)
        y_max = min(int(np.ceil(ys.max() - 0.5)), H - 1)
        if x_min > x_max or y_min > y_max:
            continue

        px = np.arange(x_min, x_max + 1) + 0.5
        py = np.arange(y_min, y_max + 1) + 0.5
        gx, gy = np.meshgrid(px, py)

        # edge functions -> barycentric (sign-agnostic: no backface culling,
        # matching the reference which never enables GL_CULL_FACE)
        area = (xs[1] - xs[0]) * (ys[2] - ys[0]) - (ys[1] - ys[0]) * (xs[2] - xs[0])
        if abs(area) < 1e-12:
            continue
        w0 = ((xs[1] - gx) * (ys[2] - gy) - (ys[1] - gy) * (xs[2] - gx)) / area
        w1 = ((xs[2] - gx) * (ys[0] - gy) - (ys[2] - gy) * (xs[0] - gx)) / area
        w2 = 1.0 - w0 - w1

        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue

        # perspective-correct interpolation: lerp attr/z and 1/z
        izs = np.array([inv_z[i0], inv_z[i1], inv_z[i2]])
        iz = w0 * izs[0] + w1 * izs[1] + w2 * izs[2]
        z_frag = 1.0 / np.maximum(iz, 1e-30)

        inside &= (z_frag >= near) & (z_frag <= far)
        if not inside.any():
            continue

        # depth test (LESS)
        sub_depth = depth_buf[y_min : y_max + 1, x_min : x_max + 1]
        win = inside & (z_frag < sub_depth)
        if not win.any():
            continue

        def interp(a):
            num = (
                w0[..., None] * (a[i0] * inv_z[i0])
                + w1[..., None] * (a[i1] * inv_z[i1])
                + w2[..., None] * (a[i2] * inv_z[i2])
            )
            return num / iz[..., None]

        n_frag = interp(n_gl)
        rgb = shade(
            n_frag, interp(l_gl), interp(v_gl), interp(color),
            ambient, diffuse, specular,
        )

        sub_color = color_buf[y_min : y_max + 1, x_min : x_max + 1]
        sub_depth[win] = z_frag[win]
        sub_color[win] = rgb[win]
        if return_normals:
            nn = n_frag / np.maximum(
                np.linalg.norm(n_frag, axis=-1, keepdims=True), 1e-12
            )
            normal_buf[y_min : y_max + 1, x_min : x_max + 1][win] = (
                nn[win] * 0.5 + 0.5
            )

    bgr = np.round(np.clip(color_buf[..., ::-1], 0.0, 1.0) * 255.0).astype(np.uint8)
    depth = np.where(np.isinf(depth_buf), 0.0, depth_buf).astype(np.float32)
    if return_normals:
        return bgr, depth, normal_buf.astype(np.float32)
    return bgr, depth
