"""`python -m augmentedautoencoder_torch.cli.ae_eval <[group/]experiment>
<eval_name> [--eval_cfg eval.cfg] [--at_step N]` -- full single-object
evaluation (reference auto_pose/eval/ae_eval.py; port of
augmentedautoencoder_tpu/cli/ae_eval.py).

Loads test scenes (BOP json or legacy sixd yaml layout), estimates poses via
the batched codebook path (+optional ICP) on the device, computes the
configured error metrics, scores 6D localization recall, and writes results,
scores, figures and a LaTeX report under <log_dir>/eval/<eval_name>/<data>.

Runs on the GPU: without CUDA it raises unless `main` is given
device="cpu". The encoder and the ICP loop run in f32 without TF32. With
COMPUTE_PLOTS the figures need matplotlib, and the reconstruction grid a
checkpoint with the decoder (one that training wrote): either missing
raises before any estimate, naming the key.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import factory
from .. import workspace as ws
from ..codebook import f32_without_tf32
from ..config.eval_config import load_eval_config
from ..evaluation import plots
from ..evaluation.evaluator import Evaluator
from . import split_experiment_name


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    """Evaluate on `device` (default: the GPU). Returns {"eval_dir",
    "results", "scores", "seconds"}: the per-stage host seconds of the
    Evaluator plus "setup" (restore, mesh, renderer) and "figures"
    (plots and report)."""
    parser = argparse.ArgumentParser(prog="ae_eval")
    parser.add_argument("experiment_name")
    parser.add_argument("evaluation_name")
    parser.add_argument("--eval_cfg", default="eval.cfg")
    parser.add_argument("--at_step", type=int, default=None)
    args = parser.parse_args(argv)

    t_setup = time.perf_counter()
    device = torch.device(device) if device is not None else factory.default_device()
    experiment_name, experiment_group = split_experiment_name(args.experiment_name)
    workspace_path = ws.get_workspace_path()

    eval_cfg_path = ws.get_eval_config_file_path(workspace_path, args.eval_cfg)
    eval_cfg = load_eval_config(eval_cfg_path)
    want_grid = eval_cfg.reconstruction or eval_cfg.reconstruction_test_batch
    if eval_cfg.compute_plots and not plots.have_matplotlib():
        raise ImportError(
            f"{eval_cfg_path}: COMPUTE_PLOTS is True but matplotlib is not installed; "
            "set [PLOT] COMPUTE_PLOTS: False to evaluate without figures"
        )

    codebook, dataset, decode = factory.build_codebook_from_name(
        experiment_name, experiment_group, return_dataset=True,
        return_decoder=True, at_step=args.at_step, device=device,
    )
    if eval_cfg.compute_plots and want_grid and decode is None:
        key = "RECONSTRUCTION" if eval_cfg.reconstruction else "RECONSTRUCTION_TEST_BATCH"
        raise ValueError(
            f"{eval_cfg_path}: [PLOT] {key} needs the decoder, and the checkpoint of "
            f"{args.experiment_name} holds none (an encoder-only one); set {key}: False"
        )
    train_cfg = dataset.cfg

    # model geometry for add/adi/proj + vsd rendering
    model_pts = None
    model_diameter = None
    renderer = None
    if os.path.exists(train_cfg.model_path):
        from ..renderer.mesh import load_mesh

        mesh = load_mesh(
            train_cfg.model_path,
            vertex_scale=train_cfg.vertex_scale,
            cache_dir=ws.get_dataset_path(workspace_path),
        )
        model_pts = mesh.vertices
        model_diameter = mesh.diameter
        renderer = dataset.renderer

    icp_handle = None
    if eval_cfg.icp:
        from ..pose.icp import ICP, SynRenderer

        icp_inner = ICP({eval_cfg.obj_id: SynRenderer(renderer)}, device=device)

        class _Refiner:
            """Binds the eval object's class_name into the multi-object ICP
            (the evaluator calls refine() without one)."""

            def refine(self, depth, R, t, K, dims, **kw):
                kw.setdefault("class_name", eval_cfg.obj_id)
                return icp_inner.refine(depth, R, t, K, dims, **kw)

            def refine_batch(self, depths, Rs, ts, K, dims, **kw):
                kw.setdefault("class_name", eval_cfg.obj_id)
                return icp_inner.refine_batch(depths, Rs, ts, K, dims, **kw)

        icp_handle = _Refiner()

    data_tag = f"{eval_cfg.dataset}_{eval_cfg.cam_type}" if eval_cfg.cam_type else eval_cfg.dataset
    log_dir = ws.get_log_dir(workspace_path, experiment_name, experiment_group)
    eval_dir = ws.get_eval_dir(log_dir, args.evaluation_name, data_tag)
    os.makedirs(eval_dir, exist_ok=True)

    evaluator = Evaluator(
        codebook, train_cfg, eval_cfg,
        renderer=renderer, model_pts=model_pts, model_diameter=model_diameter,
        icp_handle=icp_handle, device=device,
    )
    setup_s = time.perf_counter() - t_setup
    with f32_without_tf32():
        out = evaluator.run(eval_dir)

    t_fig = time.perf_counter()
    if eval_cfg.compute_plots and out["results"]:
        with f32_without_tf32():
            _figures(eval_cfg, out, eval_dir, codebook, dataset, decode, renderer, train_cfg)

    # LaTeX report (reference eval/latex_report.py; pdflatex optional)
    from ..evaluation.latex_report import generate_report

    train_cfg_text = ""
    exp_cfg_file = factory.experiment_paths(experiment_name, experiment_group)["exp_cfg_file"]
    if os.path.exists(exp_cfg_file):
        with open(exp_cfg_file) as fh:
            train_cfg_text = fh.read()
    with open(eval_cfg_path) as fh:
        eval_cfg_text = fh.read()
    generate_report(
        eval_dir, f"{experiment_name} / {args.evaluation_name}",
        train_cfg_text, eval_cfg_text,
    )

    print(f"eval written to {eval_dir}")
    for et, s in out["scores"].items():
        print(f"  {et}: recall={s['recall']:.4f} ({s['n_correct']}/{s['n_gt']})")
    seconds = dict(evaluator.seconds, setup=setup_s, figures=time.perf_counter() - t_fig)
    return {"eval_dir": eval_dir, "results": out["results"], "scores": out["scores"], "seconds": seconds}


def _figures(eval_cfg, out, eval_dir, codebook, dataset, decode, renderer, train_cfg) -> None:
    """The [PLOT] figures of one evaluation (the JAX ae_eval's)."""
    # per-figure toggles mirror the reference's [PLOT] section
    # (auto_pose/eval/ae_eval.py:256-276): the cum_*_error_hist keys
    # gate that error type's hist + cumulative-recall curves
    hist_toggle = {
        "te": eval_cfg.cum_t_error_hist,
        "re": eval_cfg.cum_r_error_hist,
        "vsd": eval_cfg.cum_vsd_error_hist,
    }
    for et in eval_cfg.error_types:
        if not hist_toggle.get(et, True):
            continue
        errs = [r.errors[et] for r in out["results"] if et in r.errors]
        if errs:
            plots.plot_error_hist(errs, et, eval_dir)
            thresh = out["scores"].get(et, {}).get("threshold")
            plots.plot_cumulative_error(errs, et, eval_dir, thresh)
    if out["scores"]:
        plots.plot_scores_bar(out["scores"], eval_dir)
    embedding = None if codebook.embedding_normalized is None else codebook.embedding_normalized.cpu().numpy()
    if eval_cfg.embedding_pca and embedding is not None:
        plots.plot_embedding_pca(embedding, eval_dir)
    if eval_cfg.viewsphere:
        # reference eval_plots.py:292-299: scatter of each embedded
        # view's camera-frame z-axis, one point per view (cyclo
        # rotations share a viewpoint, so subsample like ae_eval.py:260)
        views = dataset.viewsphere_for_embedding[:: train_cfg.num_cyclo]
        plots.plot_viewsphere(views[:, 2, :], eval_dir)

    # occlusion-binned analysis (reference eval_plots.py:540-662):
    # vsd-vs-visibility and rectified-re-vs-visibility boxplots
    occl_toggle = {
        "vsd": eval_cfg.vsd_occlusion,
        "re": eval_cfg.r_error_occlusion,
    }
    for et in ("vsd", "re"):
        if not occl_toggle[et]:
            continue
        pairs = [
            (r.errors[et], r.visib_fract)
            for r in out["results"]
            if et in r.errors and r.visib_fract is not None
        ]
        if pairs:
            errs, vis = zip(*pairs)
            plots.plot_error_vs_visibility(errs, vis, et, eval_dir)

    # scene overlay with the (raw + refined) estimate
    # (reference eval_plots.py:210-265, written to disk)
    ov = out.get("overlay_sample")
    if ov is not None and renderer is not None and eval_cfg.scene_with_estimate:
        W, H = ov["dims"]
        obj_render, _ = renderer.render(
            0, W, H, ov["K"], ov["R_raw"], ov["t_raw"], 10.0, 10000.0,
            random_light=False,
        )
        refined_render = None
        if ov["R_refined"] is not None:
            refined_render, _ = renderer.render(
                0, W, H, ov["K"], ov["R_refined"], ov["t_refined"],
                10.0, 10000.0, random_light=False,
            )
        plots.plot_scene_with_estimate(
            ov["img"], obj_render, ov["bbox"], ov["score"], ov["obj_id"],
            os.path.join(eval_dir, "scene_with_estimate.png"),
            refined_render=refined_render,
        )

    # reconstruction grid + nearest-neighbor strips
    # (reference eval_plots.py:37-72; RECONSTRUCTION and
    # RECONSTRUCTION_TEST_BATCH both map onto the one batched grid here)
    sample = out.get("sample_crops") or []
    want_grid = eval_cfg.reconstruction or eval_cfg.reconstruction_test_batch
    if sample and (
        want_grid or eval_cfg.nearest_neighbors or eval_cfg.animate_embedding_pca
    ):
        # tiles() pads the 4x4 grid when fewer than 16
        x = np.stack(sample[:16]).astype(np.float32) / 255.0
        if want_grid or eval_cfg.animate_embedding_pca:
            z = codebook.test_embedding(x, normalized=False).reshape(len(x), -1)
        if want_grid:
            reconst = decode(z).cpu().numpy()
            plots.plot_reconstruction_grid(x, reconst, eval_dir)
        if eval_cfg.animate_embedding_pca and embedding is not None:
            # the backdrop is the unit-norm codebook cloud, so the
            # trajectory codes are unit-normalized too
            z_unit = np.asarray(z, np.float64)
            z_unit = z_unit / np.maximum(
                np.linalg.norm(z_unit, axis=1, keepdims=True), 1e-12
            )
            plots.animate_embedding_path(embedding, z_unit, eval_dir)
        if renderer is not None and eval_cfg.nearest_neighbors:
            rows = []
            for xi in x[:4]:
                Rs_nn = codebook.nearest_rotation((xi * 255).astype(np.uint8), top_n=8)
                row = [xi]
                for R_nn in np.asarray(Rs_nn).reshape(-1, 3, 3):
                    row.append(dataset.render_rot(R_nn, downSample=1) / 255.0)
                rows.append(row)
            plots.plot_nearest_neighbors(rows, eval_dir)


if __name__ == "__main__":
    main()
