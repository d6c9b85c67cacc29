"""The port imports and serves with jax, flax, orbax, OpenCV, TensorFlow and
the JAX package itself blocked; no module of the port imports jax,
TensorFlow or the JAX package; its entry points refuse to fall back to the CPU; and its re-homed
pose interfaces match the JAX package's field for field."""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
    import os, pkgutil, sys, importlib
    for m in ("jax", "jaxlib", "flax", "orbax", "orbax.checkpoint", "optax", "cv2", "tensorflow",
              "augmentedautoencoder_tpu"):
        sys.modules[m] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import augmentedautoencoder_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for want in ("evaluation.evaluator", "evaluation.pose_errors", "evaluation.scene_loader",
                 "evaluation.plots", "cli.ae_eval", "cli.compute_eval_errors", "cli.compute_bop_results",
                 "cli.ae_init_workspace", "config.eval_config", "cli.ae_import_tf", "training.tf_bundle",
                 "training.tf_interop", "models.reference", "utils.draw", "utils._glyphs",
                 "visualization", "visualization.box3d", "visualization.render_pose", "pose.detectors",
                 "pose.label_map", "pose.webcam_video_stream", "cli.aae_image", "cli.aae_webcam",
                 "cli.detector_webcam_pose", "renderer.scenerenderer", "renderer.write_xml",
                 "cli.generate_syn_det_train", "cli.generate_sixd_train"):
        assert pkg.__name__ + "." + want in names, want
    for name in names:
        importlib.import_module(name)
    assert sys.modules.get("matplotlib") is None, "a module imports matplotlib at import time"
    sys.path.insert(0, os.path.join({repo!r}, "tests"))
    from _torch_port_ws import TINY_CFG, make_frames, write_test_cfg
    from augmentedautoencoder_torch import workspace as ws
    from augmentedautoencoder_torch.models import AAE
    from augmentedautoencoder_torch.training.checkpoint import CheckpointManager
    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch.serving import PoseServer

    root = sys.argv[1]
    os.environ["AE_WORKSPACE_PATH"] = root
    ws.init_workspace(root)
    with open(ws.get_config_file_path(root, "obj"), "w") as fh:
        fh.write(TINY_CFG)
    cfg, paths = factory.load_experiment_config("obj")
    torch.manual_seed(0)
    model = AAE.from_config(cfg)
    from augmentedautoencoder_torch.geometry import view_sampler
    n = len(view_sampler.viewsphere_rotations(cfg.min_n_views, cfg.num_cyclo, cfg.radius))
    rng = np.random.RandomState(0)
    emb = rng.randn(n, 16).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    bbs = np.tile(np.array([[50, 30, 28, 36]], np.int32), (n, 1))
    CheckpointManager(paths["checkpoint_dir"]).save(5, model.state_dict(), emb, bbs)
    server = PoseServer(write_test_cfg(os.path.join(root, "t.cfg"), {{"c": "obj"}}),
                        max_dets_per_class=2, device="cpu")
    out = server.process(**make_frames(["c"], 1, 3, seed=0)[0])
    assert len(out) == 3 and all(np.isfinite(p.trafo).all() for p in out)
    blocked = [m for m in ("jax", "flax", "orbax", "cv2", "tensorflow", "augmentedautoencoder_tpu")
               if sys.modules.get(m) is not None]
    assert not blocked, blocked
    print("OK", len(names))
    """
)


def test_port_imports_and_serves_without_jax_flax_orbax_cv2(tmp_path):
    """Also without the JAX package: the port keeps its own copies."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(repo=REPO), str(tmp_path / "ws")],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().startswith("OK")


def test_interfaces_match_jax_package():
    from augmentedautoencoder_tpu.pose import interfaces as jint
    from augmentedautoencoder_torch.pose import interfaces as tint

    for name in ("Roi3D", "PoseEstimate", "BoundingBox"):
        want = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(jint, name))]
        got = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(tint, name))]
        assert got == want, name
    for name in ("PoseEstInterface", "BoundingBoxDetector"):
        want = {k for k, v in vars(getattr(jint, name)).items() if callable(v) or isinstance(v, staticmethod)}
        got = {k for k, v in vars(getattr(tint, name)).items() if callable(v) or isinstance(v, staticmethod)}
        assert got == want, name
        assert getattr(getattr(tint, name), "__abstractmethods__") == getattr(
            getattr(jint, name), "__abstractmethods__"
        )
    box = tint.BoundingBox(0.1, 0.2, 0.5, 0.9, {"a": 0.2, "b": 0.7})
    jbox = jint.BoundingBox(0.1, 0.2, 0.5, 0.9, {"a": 0.2, "b": 0.7})
    assert box.best_class == jbox.best_class and box.to_xywh(640, 480) == jbox.to_xywh(640, 480)
    assert inspect.signature(tint.PoseEstInterface.process) == inspect.signature(jint.PoseEstInterface.process)


def _imported_modules(path):
    """Absolute module names that `path` imports (relative imports resolved)."""
    package = os.path.relpath(path, REPO)[: -len(".py")].split(os.sep)[:-1]
    names = []
    for node in ast.walk(ast.parse(open(path).read(), filename=path)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package[: len(package) - node.level + 1] if node.level else []
            names.append(".".join(base + ([node.module] if node.module else [])))
    return names


@pytest.mark.parametrize("root", ["augmentedautoencoder_torch", "chip_smoke.py", "scripts/chip_multi_gpu.py"])
def test_no_port_module_imports_jax_or_the_jax_package(root):
    """Nor TensorFlow: the card's machine has none."""
    top = os.path.join(REPO, root)
    files = [top] if top.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs if f.endswith(".py")
    ]
    assert len(files) >= (1 if top.endswith(".py") else 30)
    bad = [
        (os.path.relpath(f, REPO), name)
        for f in files
        for name in _imported_modules(f)
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "tensorflow", "augmentedautoencoder_tpu")
    ]
    assert not bad, bad


@pytest.mark.parametrize("path", ["chip_smoke.py", "scripts/quality_eval_vsd_torch.py",
                                  "scripts/train_grad_precision.py", "scripts/chip_multi_gpu.py"])
def test_port_scripts_read_no_file_of_the_jax_package(path):
    """Their paths into the repo name the port's files (chip_smoke's
    template is the port's own copy); the JAX package appears only in the
    `replaces` file:line strings of chip_smoke's kernel line."""
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read())
    joined = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "join"
              and any(isinstance(a, ast.Constant) and a.value == "augmentedautoencoder_tpu" for a in node.args)]
    assert not joined
    strings = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)
               and "augmentedautoencoder_tpu" in n.value]
    assert all(s.startswith("augmentedautoencoder_tpu/ops/") and ".py:" in s for s in strings), strings
    if path == "chip_smoke.py":
        import importlib.util

        spec = importlib.util.spec_from_file_location("chip_smoke_paths", os.path.join(REPO, path))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.TEMPLATE == os.path.join(REPO, "augmentedautoencoder_torch", "cfg_templates", "train_template.cfg")
        assert os.path.isfile(mod.TEMPLATE)


def test_default_device_raises_without_cuda(monkeypatch):
    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch.codebook import Codebook
    from augmentedautoencoder_torch.pose.icp import ICP

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        factory.default_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Codebook(None, [], None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ICP({})
    assert Codebook(None, [], None, device="cpu").device.type == "cpu"
    assert ICP({}, device="cpu").device.type == "cpu"
