"""Evaluation plots (reference auto_pose/eval/eval_plots.py, matplotlib;
copy of augmentedautoencoder_tpu/evaluation/plots.py;
`plot_scene_with_3d_boxes` draws through `visualization/box3d` and writes
its PNG with `utils/png.write_png`, so it needs neither OpenCV nor
matplotlib).

Rebuilt set: per-metric error histograms + cumulative error curves, codebook
embedding PCA scatter, viewsphere scatter, recall bars, occlusion-binned
error boxplots (eval_plots.py:540-662), scene-with-estimate overlays
(eval_plots.py:210-265, written to disk instead of cv2.imshow), and the
reconstruction / nearest-neighbor grids (eval_plots.py:37-72). All figures
are written as PNGs into the eval dir (headless Agg backend); the
paper-facing ones get .tex twins (tikz.py).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np


def have_matplotlib() -> bool:
    """Whether matplotlib imports (the figures need it; nothing else does)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_error_hist(errors: Sequence[float], error_type: str, out_dir: str) -> str:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.hist(np.asarray(errors), bins=30, color="#4878d0")
    ax.set_xlabel(f"{error_type} error")
    ax.set_ylabel("count")
    ax.set_title(f"{error_type} error histogram ({len(errors)} estimates)")
    path = os.path.join(out_dir, f"error_hist_{error_type}.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    from .tikz import write_hist_tikz

    write_hist_tikz(errors, error_type, out_dir)  # paper-ready .tex twin
    return path


def plot_cumulative_error(
    errors: Sequence[float], error_type: str, out_dir: str, threshold: Optional[float] = None
) -> str:
    plt = _plt()
    errs = np.sort(np.asarray(errors))
    frac = np.arange(1, len(errs) + 1) / len(errs)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(errs, frac, color="#4878d0")
    if threshold is not None:
        ax.axvline(threshold, color="#d65f5f", linestyle="--", label=f"thresh {threshold:g}")
        ax.legend()
    ax.set_xlabel(f"{error_type} error")
    ax.set_ylabel("recall")
    ax.set_ylim(0, 1)
    ax.set_title(f"cumulative {error_type} error")
    path = os.path.join(out_dir, f"cumulative_{error_type}.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    from .tikz import write_cumulative_tikz

    write_cumulative_tikz(errors, error_type, out_dir, threshold=threshold)
    return path


def _pca_project(
    embedding: np.ndarray,
    test_codes: Optional[np.ndarray],
    n_components: int,
) -> tuple:
    """Center the codebook, PCA it via SVD (no sklearn dependency), and
    project the optional test codes into the SAME basis (same mean, same
    right-singular vectors). Shared by plot_embedding_pca and
    animate_embedding_path so the projection math cannot diverge."""
    x = np.asarray(embedding, np.float64)
    mean = x.mean(axis=0)
    x = x - mean
    _, _, Vt = np.linalg.svd(x, full_matrices=False)
    proj = x @ Vt[:n_components].T
    tc = None
    if test_codes is not None:
        tc = (np.asarray(test_codes, np.float64) - mean) @ Vt[:n_components].T
    return proj, tc


def plot_embedding_pca(
    embedding: np.ndarray, out_dir: str, test_codes: Optional[np.ndarray] = None
) -> str:
    """3-component PCA of the codebook (eval_plots.py:267-289)."""
    plt = _plt()
    proj, tc = _pca_project(embedding, test_codes, 3)
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(proj[:, 0], proj[:, 1], proj[:, 2], s=1, c=np.arange(len(proj)), cmap="viridis")
    if tc is not None:
        ax.scatter(tc[:, 0], tc[:, 1], tc[:, 2], s=20, c="red", marker="x")
    ax.set_title("codebook embedding PCA-3")
    path = os.path.join(out_dir, "embedding_pca.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def animate_embedding_path(
    embedding: np.ndarray,
    test_codes: np.ndarray,
    out_dir: str,
    fps: int = 4,
    max_frames: int = 60,
) -> str:
    """Animated PCA trajectory of the eval crops' latent codes
    (embedding_path.gif).

    The reference declares this figure but ships an EMPTY STUB
    (eval_plots.py:664-665: `def animate_embedding_path(..): pass`); this
    is a working implementation: the codebook's 2-component PCA cloud as
    the backdrop, with the test-sequence codes projected into the same
    basis and traced frame by frame (path line + current-position marker).
    """
    plt = _plt()
    from matplotlib import animation

    proj, tc = _pca_project(embedding, test_codes, 2)
    tc = tc[:max_frames]

    fig, ax = plt.subplots(figsize=(6, 5))
    ax.scatter(proj[:, 0], proj[:, 1], s=1, c=np.arange(len(proj)),
               cmap="viridis", alpha=0.4)
    (path_line,) = ax.plot([], [], "r-", lw=1.5)
    (head,) = ax.plot([], [], "rx", markersize=10)
    # axes must cover BOTH clouds: FuncAnimation set_data never rescales,
    # so a trajectory outside the backdrop's limits would silently render
    # off-screen (the bug fixed in cli/ae_eval.py — callers must pass
    # unit-normalized codes, but keep the figure honest regardless)
    both = np.concatenate([proj, tc], axis=0)
    lo, hi = both.min(axis=0), both.max(axis=0)
    pad = 0.05 * (hi - lo + 1e-9)
    ax.set_xlim(lo[0] - pad[0], hi[0] + pad[0])
    ax.set_ylim(lo[1] - pad[1], hi[1] + pad[1])
    ax.set_title("test-sequence path through the embedding (PCA-2)")

    def draw(i):
        path_line.set_data(tc[: i + 1, 0], tc[: i + 1, 1])
        head.set_data(tc[i : i + 1, 0], tc[i : i + 1, 1])
        return path_line, head

    anim = animation.FuncAnimation(fig, draw, frames=len(tc), blit=True)
    path = os.path.join(out_dir, "embedding_path.gif")
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path


def plot_viewsphere(pts: np.ndarray, out_dir: str) -> str:
    plt = _plt()
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=2)
    ax.set_title(f"viewsphere ({len(pts)} views)")
    path = os.path.join(out_dir, "viewsphere.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_error_vs_visibility(
    errors: Sequence[float],
    visib_fracts: Sequence[float],
    error_type: str,
    out_dir: str,
    bins: int = 10,
) -> str:
    """Occlusion-binned error boxplots: one box per visibility bin
    (reference eval_plots.py:540-605 for vsd, :607-662 for re).

    Rotation errors are rectified to min(err, 180-err) as the reference
    does for re; bin edges are the 10 equal visibility deciles in [0, 1]
    and each box title carries the per-bin estimate counts.
    """
    plt = _plt()
    errs = np.asarray(errors, np.float64)
    vis = np.asarray(visib_fracts, np.float64)
    assert errs.shape == vis.shape, (errs.shape, vis.shape)
    if error_type == "re":
        errs = np.minimum(errs, 180.0 - errs)

    # Closed outer edges (deviation from the reference, whose strict
    # `> lo & < hi` bins drop visib_fract exactly 0.0 and 1.0 — common
    # values in real BOP gt_info): first bin includes 0.0, every bin
    # includes its upper bound, so bin counts sum to len(errors).
    bounds = np.linspace(0.0, 1.0, bins + 1)
    bin_errs, bin_count = [], []
    for idx in range(bins):
        lo_ok = vis >= bounds[idx] if idx == 0 else vis > bounds[idx]
        sel = lo_ok & (vis <= bounds[idx + 1])
        bin_errs.append(errs[sel])
        bin_count.append(int(sel.sum()))
    centers = bounds[:-1] + (bounds[1] - bounds[0]) / 2.0

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.boxplot(bin_errs, positions=centers, widths=0.5 / bins, sym="+")
    ax.set_xlim(0.0, 1.0)
    ax.set_xticks(centers)
    ax.set_xticklabels([f"{c:.2f}" for c in centers], fontsize=7)
    ax.grid(True, alpha=0.4)
    ax.set_xlabel("visibility [fraction]")
    ax.set_ylabel(f"{error_type} err" + (" [deg]" if error_type == "re" else ""))
    ax.set_title(f"visibility vs {error_type} error, bin counts {bin_count}", fontsize=8)
    # reference file naming: vsd_occlusion / R_err_occlusion
    stem = "R_err_occlusion" if error_type == "re" else f"{error_type}_occlusion"
    path = os.path.join(out_dir, f"{stem}.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    from .tikz import write_boxplot_tikz

    write_boxplot_tikz(bin_errs, centers, stem, out_dir, counts=bin_count)
    return path


def plot_scene_with_estimate(
    scene_img: np.ndarray,
    obj_render: np.ndarray,
    bbox: Sequence[float],
    score: float,
    obj_id: int,
    out_path: str,
    refined_render: Optional[np.ndarray] = None,
) -> str:
    """Scene overlay with the estimated pose (eval_plots.py:210-265),
    written to disk (headless) instead of cv2.imshow.

    obj_render / refined_render are full-scene-size renders of the estimate
    (zeros off the object). The raw estimate replaces scene pixels; the
    refined estimate is blended as 2/3 green-channel + 1/3 scene, exactly
    the reference's "refined" look.
    """
    plt = _plt()
    scene = np.asarray(scene_img).astype(np.float32)
    if scene.ndim == 2:
        scene = np.repeat(scene[..., None], 3, axis=2)

    panels = []
    obj = np.asarray(obj_render, np.float32)
    view = scene.copy()
    view[obj > 0] = obj[obj > 0]
    panels.append(("estimate", view))

    if refined_render is not None:
        ref = np.asarray(refined_render, np.float32)
        g = np.zeros_like(ref)
        g[:, :, 1] = ref[:, :, 1]
        view_r = scene.copy()
        mask = ref > 0
        view_r[mask] = g[mask] * (2.0 / 3.0) + view_r[mask] * (1.0 / 3.0)
        panels.append(("refined", view_r))

    x, y, w, h = [float(v) for v in bbox]
    fig, axes = plt.subplots(1, len(panels), figsize=(6 * len(panels), 5))
    if len(panels) == 1:
        axes = [axes]
    for ax, (name, img) in zip(axes, panels):
        # scene/render arrive BGR (cv2 / rasterizer convention) — flip for
        # matplotlib's RGB display
        ax.imshow(np.clip(img, 0, 255).astype(np.uint8)[..., ::-1])
        ax.add_patch(
            plt.Rectangle((x, y), w, h, fill=False, edgecolor="#2ca02c", linewidth=2)
        )
        ax.text(
            x, y + h + 12, f"{obj_id}: {score:.3f}", color="#2ca02c", fontsize=9
        )
        ax.set_title(name)
        ax.axis("off")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_reconstruction_grid(
    x: np.ndarray, reconst: np.ndarray, out_dir: str
) -> str:
    """Side-by-side 4x4 grids of eval crops and their decoder
    reconstructions (reference eval_plots.py:37-72 writes
    figures/reconstruction_imgs.png)."""
    from ..utils.misc import tiles

    x = np.asarray(x, np.float32)
    reconst = np.asarray(reconst, np.float32)
    if x.max() > 1.5:  # uint8-scaled input
        x = x / 255.0
    grid = np.hstack((tiles(x, 4, 4), tiles(reconst, 4, 4)))
    path = os.path.join(out_dir, "reconstruction_imgs.png")
    _save_float_image(grid, path)
    return path


def plot_nearest_neighbors(rows: Sequence[Sequence[np.ndarray]], out_dir: str) -> str:
    """Per-crop strips [input | top-n codebook-neighbor renders] stacked
    vertically (reference eval_plots.py:57-70)."""
    from ..utils.misc import tiles

    strips = []
    for row in rows:
        imgs = np.stack([np.asarray(im, np.float32) for im in row])
        if imgs.max() > 1.5:
            imgs = imgs / 255.0
        strips.append(tiles(imgs, 1, len(row), 10, 10))
    all_nns = tiles(np.stack(strips), len(strips), 1, 10, 10)
    path = os.path.join(out_dir, "nearest_neighbors.png")
    _save_float_image(all_nns, path)
    return path


def plot_scene_with_3d_boxes(
    scene_img: np.ndarray,
    K: np.ndarray,
    vert_min: Sequence[float],
    vert_max: Sequence[float],
    est_poses: Sequence,
    out_path: str,
    gt_poses: Sequence = (),
) -> str:
    """Scene with projected 3D bounding boxes of the estimates (green) and
    optionally the GT poses (blue) -- reference eval_plots.py:92-207. The
    file holds the RGB pixels of the JAX function's `plt.imsave` (the BGR
    scene written as an RGB PNG). Poses are (R (3,3), t (3)) pairs."""
    from ..utils.png import write_png
    from ..visualization.box3d import draw_box3d

    img = np.asarray(scene_img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    img = np.ascontiguousarray(img.astype(np.uint8))
    for R, t in gt_poses:
        img = draw_box3d(img, vert_min, vert_max, K, R, t, color=(255, 80, 0))
    for R, t in est_poses:
        img = draw_box3d(img, vert_min, vert_max, K, R, t, color=(0, 255, 0))
    write_png(out_path, img)
    return out_path


def _save_float_image(img: np.ndarray, path: str) -> None:
    """Write a float [0,1] image; 3-channel input is BGR (the convention of
    every crop/render in this stack) and is flipped to RGB for the file."""
    plt = _plt()
    arr = np.clip(np.asarray(img, np.float64), 0.0, 1.0)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    elif arr.ndim == 3 and arr.shape[2] == 3:
        arr = arr[..., ::-1]
    plt.imsave(path, arr, cmap="gray" if arr.ndim == 2 else None)


def plot_scores_bar(scores: Dict[str, Dict], out_dir: str) -> str:
    plt = _plt()
    names = list(scores.keys())
    recalls = [scores[n]["recall"] for n in names]
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.bar(names, recalls, color="#4878d0")
    ax.set_ylabel("recall")
    ax.set_ylim(0, 1)
    for i, v in enumerate(recalls):
        ax.text(i, v + 0.02, f"{v:.3f}", ha="center")
    path = os.path.join(out_dir, "recall_by_metric.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
