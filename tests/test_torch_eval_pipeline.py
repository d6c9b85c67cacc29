"""The port's evaluation against the JAX package's, on the CPU: the
Evaluator on one synthetic BOP scene in every branch (GT boxes, boxes
rendered from the GT pose, external detections, GT_MASKS, TOPK_AGGREGATE,
TOPK_RESCORE, TTA, several instances, ICP in both geometries), and the CLIs
end to end (ae_eval with its figures and report, compute_eval_errors,
compute_bop_results), plus the refusals.

The workspace is _torch_port_ws.make_eval_workspace's: Flax parameters from
a fixed key (decoder included), a codebook of the JAX encoder's codes of
the JAX renders in which each scene instance's row holds its GT crop's
code, saved as a JAX checkpoint and as the port's `.pt`; the scene holds 3
images of 2 instances of the workspace's mesh at 300-330 mm, written by the
port's PNG writer. Both packages read the same files.

Without ICP the poses must agree to R 1e-5 and t 1e-3 mm, the errors to
1e-6 (adi 1e-5 relative: its nearest neighbour is B4's formula in the port
and an XLA distance matrix in the JAX package) and VSD exactly. ICP runs as
tests/test_torch_serving_depth.py runs it: the JAX loop on
`batched_nn_pallas` in interpret mode, both on N_SUB = 2000 points drawn
from the same seeded global numpy stream; its poses must agree to
chip_smoke.py phase 5's bounds (t 0.1 mm, R 1e-3) and its errors as those
bounds carry over. scores.json must be equal in every branch.
"""

import copy
import functools
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from _torch_port_ws import (EVAL_CFG, eval_scene_poses, global_rng_guard,  # noqa: F401
                            make_eval_workspace, write_bop_scene, write_test_cfg)

torch.set_num_threads(1)

N_SUB = 2000
ERROR_TYPES = ("vsd", "re", "te", "add", "adi", "proj")
# without ICP: errors of equal poses; with ICP: of poses within phase 5's bounds
ERR_ATOL = {"vsd": 0.0, "re": 1e-6, "te": 1e-6, "add": 1e-6, "adi": 1e-4, "proj": 1e-6}
ICP_ERR_ATOL = {"vsd": 0.02, "re": 0.1, "te": 0.1, "add": 0.1, "adi": 0.1, "proj": 0.1}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eval_ws")
    old = os.environ.get("AE_WORKSPACE_PATH")
    poses, rows = eval_scene_poses(n_images=3, instances=2, seed=0)
    ws_path, ply, data_root = make_eval_workspace(root, poses, rows)
    no_box = write_bop_scene(root / "data_no_box", ply, poses, bbox=False)
    yield {"root": root, "ws": ws_path, "ply": ply, "data": data_root, "data_no_box": os.path.dirname(
        os.path.dirname(no_box)), "poses": poses}
    if old is None:
        os.environ.pop("AE_WORKSPACE_PATH", None)
    else:
        os.environ["AE_WORKSPACE_PATH"] = old


@pytest.fixture(autouse=True)
def _env(ws, monkeypatch, tmp_path):
    from augmentedautoencoder_tpu.ops.icp_nn import batched_nn_pallas
    from augmentedautoencoder_tpu.pose import icp as jicp
    from augmentedautoencoder_torch.pose import icp as ticp

    monkeypatch.setenv("AE_WORKSPACE_PATH", ws["ws"])
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setenv("AAE_ICP_NN", "pallas")
    monkeypatch.setattr(jicp, "batched_nn_pallas", functools.partial(batched_nn_pallas, interpret=True))
    monkeypatch.setattr(jicp, "N_SUB", N_SUB)
    monkeypatch.setattr(ticp, "N_SUB", N_SUB)
    jicp.icp_jax_batch.clear_cache()
    yield
    jicp.icp_jax_batch.clear_cache()


def _eval_cfg(ws, **changes):
    from augmentedautoencoder_torch.config import load_eval_config

    path = os.path.join(ws["ws"], "cfg_eval", "base.cfg")
    with open(path, "w") as fh:
        fh.write(EVAL_CFG.format(dataset_path=ws["data"]))
    ec = load_eval_config(path)
    for k, v in changes.items():
        setattr(ec, k, v)
    return ec


def _detections(ws, path):
    """GT boxes of every image, widened by 2 px and shifted by 1, scored
    0.9 and 0.6, plus one box of another object."""
    with open(os.path.join(ws["data"], "test", "000001", "scene_gt_info.json")) as fh:
        info = json.load(fh)
    dets = {"1": {im: [{"obj_id": 1, "bbox": [x - 1, y, w + 2, h], "score": 0.9 - 0.3 * m}
                       for m, (x, y, w, h) in enumerate(i["bbox_obj"] for i in insts)]
                  + [{"obj_id": 7, "bbox": [0, 0, 20, 20], "score": 1.0}]
                  for im, insts in info.items()}}
    with open(path, "w") as fh:
        json.dump(dets, fh)
    return str(path)


VARIANTS = {
    "template": {},
    "rendered_gt_boxes": {"dataset_path": "data_no_box"},
    "several_instances": {"single_instance": False},
    "external_detections": {"estimate_bbs": True, "detections_path": "dets"},
    "gt_masks": {"gt_masks": True, "single_instance": False},
    "topk_aggregate_4": {"topk_aggregate": 4},
    "topk_rescore_2": {"topk_rescore": 2, "single_instance": False},
    "tta_3": {"tta_crops": 3},
    "icp": {"icp": True},
    "icp_frame_accurate": {"icp": True, "icp_frame_accurate": True, "single_instance": False},
}


def _build(package, ec, ws):
    """(Evaluator of `package` ("jax" or "port") for `ec`, its renderer)."""
    if package == "jax":
        from augmentedautoencoder_tpu import factory
        from augmentedautoencoder_tpu.evaluation.evaluator import Evaluator
        from augmentedautoencoder_tpu.pose.icp import ICP, SynRenderer
        from augmentedautoencoder_tpu.renderer.mesh import load_mesh

        codebook, dataset = factory.build_codebook_from_name("obj", return_dataset=True)
        icp = ICP({1: SynRenderer(dataset.renderer)}) if ec.icp else None
    else:
        from augmentedautoencoder_torch import factory
        from augmentedautoencoder_torch.evaluation.evaluator import Evaluator
        from augmentedautoencoder_torch.pose.icp import ICP, SynRenderer
        from augmentedautoencoder_torch.renderer.mesh import load_mesh

        codebook, dataset = factory.build_codebook_from_name("obj", return_dataset=True, device="cpu")
        icp = ICP({1: SynRenderer(dataset.renderer)}, device="cpu") if ec.icp else None
    mesh = load_mesh(ws["ply"])
    return Evaluator(codebook, dataset.cfg, ec, renderer=dataset.renderer, model_pts=mesh.vertices,
                     model_diameter=mesh.diameter, icp_handle=icp)


def _assert_results_agree(got, want, icp):
    assert len(got) == len(want) > 0
    t_tol, r_tol = (0.1, 1e-3) if icp else (1e-3, 1e-5)
    atol = ICP_ERR_ATOL if icp else ERR_ATOL
    for g, w in zip(got, want):
        assert (g.scene_id, g.im_id, g.obj_id, g.gt_idx, g.score, g.visib_fract) == (
            w.scene_id, w.im_id, w.obj_id, w.gt_idx, w.score, w.visib_fract)
        np.testing.assert_allclose(g.R_est, w.R_est, rtol=0, atol=r_tol)
        np.testing.assert_allclose(g.t_est, w.t_est, rtol=0, atol=t_tol)
        assert set(g.errors) == set(w.errors) == set(ERROR_TYPES)
        for et in ERROR_TYPES:
            rtol = 1e-5 if et == "adi" else 0.0
            np.testing.assert_allclose(g.errors[et], w.errors[et], rtol=rtol, atol=atol[et], err_msg=et)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_evaluator_matches_jax(ws, tmp_path, variant):
    changes = dict(VARIANTS[variant])
    if changes.get("dataset_path") == "data_no_box":
        changes["dataset_path"] = ws["data_no_box"]
    if changes.get("detections_path") == "dets":
        changes["detections_path"] = _detections(ws, tmp_path / "dets.json")
    ec = _eval_cfg(ws, **changes)
    out = {}
    for package in ("jax", "port"):
        np.random.seed(11)  # ICP's subsampling draws from the global stream
        out[package] = _build(package, copy.deepcopy(ec), ws).run(str(tmp_path / package), progress=False)
    got, want = out["port"], out["jax"]
    _assert_results_agree(got["results"], want["results"], ec.icp)
    assert len(got["results"]) == (3 if ec.single_instance and not ec.estimate_bbs else 6)
    assert json.load(open(tmp_path / "port" / "scores.json")) == json.load(open(tmp_path / "jax" / "scores.json"))
    assert len(got["sample_crops"]) == len(want["sample_crops"])
    for a, b in zip(got["sample_crops"], want["sample_crops"]):
        np.testing.assert_array_equal(a, b)
    if variant in ("template", "rendered_gt_boxes", "several_instances"):
        # planted rows: every GT's view retrieved, off by the lateral correction only
        assert all(r.errors["re"] < 7.0 for r in got["results"])


def _run_jax_cli(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + list(argv))
    return module.main()


def _write_eval_cfg(ws, name, text):
    with open(os.path.join(ws["ws"], "cfg_eval", name), "w") as fh:
        fh.write(text)


def test_ae_eval_cli_matches_jax(ws, monkeypatch):
    """ae_eval with COMPUTE_PLOTS and every figure: the same results, scores,
    sixd files and the same set of figures and report files."""
    from augmentedautoencoder_tpu.cli import ae_eval as jax_ae_eval
    from augmentedautoencoder_torch.cli import ae_eval
    from augmentedautoencoder_torch.evaluation.sixd_writer import load_results_sixd17

    text = EVAL_CFG.format(dataset_path=ws["data"]).replace("COMPUTE_PLOTS: False", """COMPUTE_PLOTS: True
EMBEDDING_PCA: True
VIEWSPHERE: True
RECONSTRUCTION: True
ANIMATE_EMBEDDING_PCA: True""")
    _write_eval_cfg(ws, "plots.cfg", text)
    out = ae_eval.main(["obj", "cli_port", "--eval_cfg", "plots.cfg"], device="cpu")
    _run_jax_cli(jax_ae_eval, ["obj", "cli_jax", "--eval_cfg", "plots.cfg"], monkeypatch)
    port_dir = out["eval_dir"]
    jax_dir = port_dir.replace(os.sep + "cli_port" + os.sep, os.sep + "cli_jax" + os.sep)
    got, want = (json.load(open(os.path.join(d, "results.json"))) for d in (port_dir, jax_dir))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g["scene_id"], g["im_id"], g["obj_id"], g["score"]) == (w["scene_id"], w["im_id"], w["obj_id"],
                                                                          w["score"])
        np.testing.assert_allclose(g["R"], w["R"], atol=1e-5)
        np.testing.assert_allclose(g["t"], w["t"], atol=1e-3)
        for et in ERROR_TYPES:
            np.testing.assert_allclose(g["errors"][et], w["errors"][et], rtol=1e-5 if et == "adi" else 0,
                                       atol=ERR_ATOL[et])
    assert json.load(open(os.path.join(port_dir, "scores.json"))) == json.load(
        open(os.path.join(jax_dir, "scores.json")))
    files = {d: sorted(os.listdir(d)) for d in (port_dir, jax_dir)}
    assert files[port_dir] == files[jax_dir]
    for name in ("reconstruction_imgs.png", "nearest_neighbors.png", "embedding_pca.png", "viewsphere.png",
                 "embedding_path.gif", "scene_with_estimate.png", "vsd_occlusion.tex", "report.tex"):
        assert name in files[port_dir], name
    for yml in sorted(os.listdir(os.path.join(port_dir, "01"))):
        a, b = (load_results_sixd17(os.path.join(d, "01", yml)) for d in (port_dir, jax_dir))
        for ea, eb in zip(a["ests"], b["ests"]):
            np.testing.assert_allclose(ea["R"], eb["R"], atol=1e-5)
            np.testing.assert_allclose(ea["t"], eb["t"], atol=1e-3)
    assert set(out["seconds"]) >= {"setup", "scene_load", "crop", "pose", "errors", "matching", "writing",
                                   "figures"}


def test_compute_eval_errors_matches_jax(ws, tmp_path, monkeypatch):
    """Re-scoring one eval dir (the port's ae_eval's, copied twice) with
    other thresholds: the same scores.json, byte for byte, and figures."""
    from augmentedautoencoder_tpu.cli import compute_eval_errors as jax_cee
    from augmentedautoencoder_torch.cli import ae_eval, compute_eval_errors

    _write_eval_cfg(ws, "plain.cfg", EVAL_CFG.format(dataset_path=ws["data"]))
    src = ae_eval.main(["obj", "rescore_src", "--eval_cfg", "plain.cfg"], device="cpu")["eval_dir"]
    dirs = {k: str(tmp_path / k) for k in ("port", "jax")}
    for d in dirs.values():
        shutil.copytree(src, d)
    argv = ["--error_thresh_deg", "6.5", "--error_thresh_mm", "9", "--model_diameter", "120", "--top_n_eval", "1"]
    summary = compute_eval_errors.main([dirs["port"]] + argv)
    _run_jax_cli(jax_cee, [dirs["jax"]] + argv, monkeypatch)
    a, b = (open(os.path.join(d, "scores.json"), "rb").read() for d in dirs.values())
    assert a == b
    assert summary == json.loads(a) and summary["re"]["threshold"] == 6.5
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))


@pytest.mark.parametrize("gt_masks", ["auto", "off"])
def test_compute_bop_results_matches_jax(ws, tmp_path, monkeypatch, gt_masks):
    from augmentedautoencoder_tpu.cli import compute_bop_results as jax_cbr
    from augmentedautoencoder_torch.cli import compute_bop_results
    from augmentedautoencoder_torch.evaluation.bop_writer import read_bop_csv

    with open(os.path.join(ws["data"], "test_targets_bop19.json"), "w") as fh:
        json.dump([{"scene_id": 1, "im_id": i, "obj_id": 1, "inst_count": 2} for i in range(3)], fh)
    cfg = write_test_cfg(tmp_path / "bop.cfg", {1: "obj"})
    common = [cfg, "--dataset_path", ws["data"], "--dataset_name", "synth", "--method", "aae",
              "--gt_masks", gt_masks]
    got = compute_bop_results.main(common + ["--out_dir", str(tmp_path / "port")], device="cpu")
    _run_jax_cli(jax_cbr, common + ["--out_dir", str(tmp_path / "jax")], monkeypatch)
    want = os.path.join(str(tmp_path / "jax"), os.path.basename(got))
    assert os.path.basename(got) == "aae_synth-test.csv"
    assert open(got).readline() == open(want).readline()
    a, b = read_bop_csv(got), read_bop_csv(want)
    assert len(a) == len(b) == 6
    for ea, eb in zip(a, b):
        assert (ea.scene_id, ea.im_id, ea.obj_id, ea.score) == (eb.scene_id, eb.im_id, eb.obj_id, eb.score)
        np.testing.assert_allclose(ea.R, eb.R, atol=1e-5)
        np.testing.assert_allclose(ea.t, eb.t, atol=1e-3)


def test_ae_eval_refuses_plots_without_matplotlib(ws, monkeypatch):
    """COMPUTE_PLOTS without matplotlib raises before any estimate, naming
    the key; it never skips the figures in silence."""
    from augmentedautoencoder_torch import workspace as port_ws
    from augmentedautoencoder_torch.cli import ae_eval

    _write_eval_cfg(ws, "needs_mpl.cfg", EVAL_CFG.format(dataset_path=ws["data"]).replace(
        "COMPUTE_PLOTS: False", "COMPUTE_PLOTS: True"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="COMPUTE_PLOTS"):
        ae_eval.main(["obj", "no_mpl", "--eval_cfg", "needs_mpl.cfg"], device="cpu")
    assert not os.path.exists(os.path.join(port_ws.get_log_dir(ws["ws"], "obj"), "eval", "no_mpl"))


def test_ae_eval_needs_the_decoder_only_for_the_grid(ws, tmp_path, monkeypatch):
    """An encoder-only checkpoint: the reconstruction grid raises before any
    estimate, naming its key; without the grid the evaluation runs."""
    from augmentedautoencoder_torch import workspace as port_ws
    from augmentedautoencoder_torch.cli import ae_eval
    from augmentedautoencoder_torch.training.checkpoint import CheckpointManager

    ws_copy = str(tmp_path / "workspace")
    shutil.copytree(ws["ws"], ws_copy, ignore=shutil.ignore_patterns("eval"))
    monkeypatch.setenv("AE_WORKSPACE_PATH", ws_copy)
    mgr = CheckpointManager(port_ws.get_checkpoint_dir(port_ws.get_log_dir(ws_copy, "obj")))
    payload = mgr.restore()
    assert "decoder" in payload
    mgr.save(payload["step"], payload["state_dict"], payload["embedding_normalized"], payload["embed_obj_bbs"])
    text = EVAL_CFG.format(dataset_path=ws["data"]).replace("COMPUTE_PLOTS: False", "COMPUTE_PLOTS: True")
    with open(os.path.join(ws_copy, "cfg_eval", "grid.cfg"), "w") as fh:
        fh.write(text)
    with pytest.raises(ValueError, match="RECONSTRUCTION_TEST_BATCH"):
        ae_eval.main(["obj", "grid", "--eval_cfg", "grid.cfg"], device="cpu")
    with open(os.path.join(ws_copy, "cfg_eval", "no_grid.cfg"), "w") as fh:
        fh.write(text + "RECONSTRUCTION_TEST_BATCH: False\n")
    out = ae_eval.main(["obj", "no_grid", "--eval_cfg", "no_grid.cfg"], device="cpu")
    assert len(out["results"]) == 3 and "nearest_neighbors.png" in os.listdir(out["eval_dir"])
    assert "reconstruction_imgs.png" not in os.listdir(out["eval_dir"])


def test_ae_eval_runs_on_the_gpu_unless_told(ws, monkeypatch):
    from augmentedautoencoder_torch.cli import ae_eval

    _write_eval_cfg(ws, "plain.cfg", EVAL_CFG.format(dataset_path=ws["data"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ae_eval.main(["obj", "gpu", "--eval_cfg", "plain.cfg"])


def test_decoder_matches_jax(ws):
    """factory.build_codebook_from_name(return_decoder=True) decodes as the
    JAX package's make_decode_fn does on the same codes."""
    from augmentedautoencoder_tpu import factory as jfactory
    from augmentedautoencoder_torch import factory

    _, _, jdecode = jfactory.build_codebook_from_name("obj", return_dataset=True, return_decoder=True)
    cb, ds, decode = factory.build_codebook_from_name("obj", return_dataset=True, return_decoder=True,
                                                      device="cpu")
    z = np.random.RandomState(8).randn(5, 16).astype(np.float32)
    got, want = decode(z).numpy(), np.asarray(jdecode(z))
    assert got.shape == want.shape == (5, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert ds.cfg.latent_space_size == 16 and cb.embedding_normalized.shape[1] == 16
