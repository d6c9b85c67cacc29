"""Workspace fixtures for the PyTorch port's tests, built without rendering
or training: cfgs at a tiny width, encoder params from the Flax `AAE.init`
with a fixed key, a seeded codebook saved through the JAX package's
CheckpointManager, and the port's checkpoint written by
scripts/convert_jax_checkpoint.py.
"""

import importlib.util
import os
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_converter():
    """scripts/convert_jax_checkpoint.py as a module (scripts/ is no package)."""
    path = os.path.join(REPO, "scripts", "convert_jax_checkpoint.py")
    spec = importlib.util.spec_from_file_location("convert_jax_checkpoint", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

TINY_CFG = textwrap.dedent(
    """
    [Paths]
    MODEL_PATH: /nonexistent/model.ply
    BACKGROUND_IMAGES_GLOB: /nonexistent/*.jpg

    [Dataset]
    MODEL: reconst
    H: 32
    W: 32
    C: 3
    RADIUS: 300
    RENDER_DIMS: (128, 96)
    K: [100, 0, 64, 0, 100, 48, 0, 0, 1]
    VERTEX_SCALE: 1
    ANTIALIASING: 1
    PAD_FACTOR: 1.2
    CLIP_NEAR: 10
    CLIP_FAR: 10000
    NOOF_TRAINING_IMGS: 4
    NOOF_BG_IMGS: 0

    [Augmentation]
    REALISTIC_OCCLUSION: False
    SQUARE_OCCLUSION: False
    MAX_REL_OFFSET: 0.2
    CODE: Sequential([Sometimes(0.5, Add((-25, 25), per_channel=0.3))], random_order=False)

    [Embedding]
    EMBED_BB: True
    MIN_N_VIEWS: 12
    NUM_CYCLO: 4

    [Network]
    BATCH_NORMALIZATION: False
    AUXILIARY_MASK: False
    VARIATIONAL: 0
    LOSS: L2
    BOOTSTRAP_RATIO: 4
    NORM_REGULARIZE: 0
    LATENT_SPACE_SIZE: 16
    NUM_FILTER: [8, 16]
    STRIDES: [2, 2]
    KERNEL_SIZE_ENCODER: 5
    KERNEL_SIZE_DECODER: 5

    [Training]
    OPTIMIZER: Adam
    NUM_ITER: 10
    BATCH_SIZE: 8
    LEARNING_RATE: 1e-3
    SAVE_INTERVAL: 10

    [Queue]
    NUM_THREADS: 1
    QUEUE_SIZE: 2
    """
)

TEST_CFG = textwrap.dedent(
    """
    [auto_pose]
    camPose = False
    upright = False
    topk = 1
    color_format = bgr
    color_data_type = np.float32
    depth_data_type = np.float32
    class_2_encoder = {classes}
    """
)


def write_test_cfg(path, classes, extra=""):
    """An [auto_pose] test config mapping class -> experiment."""
    text = TEST_CFG.format(classes=repr(classes))
    if "upright" in extra:
        text = text.replace("upright = False\n", "")
    with open(path, "w") as fh:
        fh.write(text + extra)
    return str(path)


def write_procedural_mesh(path, subdivisions=2, radius=45.0):
    """A textured asymmetric .ply (the port's procedural copy) at `path`."""
    from augmentedautoencoder_torch.renderer.procedural import make_textured_asymmetric, save_ply

    save_ply(make_textured_asymmetric(subdivisions=subdivisions, radius=radius), str(path))
    return str(path)


def make_jax_workspace(ws_path, experiments, step=10, model_path=None, cfg_text=None):
    """Create `experiments` (name -> seed) with Flax params and a seeded
    codebook in JAX checkpoints, then convert each with
    scripts/convert_jax_checkpoint.py. `model_path` replaces the cfg's
    MODEL_PATH (the mesh the depth stages render); `cfg_text` replaces
    TINY_CFG. Sets AE_WORKSPACE_PATH."""
    import jax
    import jax.numpy as jnp

    from augmentedautoencoder_tpu import workspace as ws
    from augmentedautoencoder_tpu.config import load_train_config
    from augmentedautoencoder_tpu.geometry import view_sampler
    from augmentedautoencoder_tpu.models import AAE
    from augmentedautoencoder_tpu.training.checkpoint import CheckpointManager

    converter = load_converter()
    text = TINY_CFG if cfg_text is None else cfg_text
    if model_path is not None:
        text = text.replace("MODEL_PATH: /nonexistent/model.ply", f"MODEL_PATH: {model_path}")
    os.environ[ws.WORKSPACE_ENV_VAR] = str(ws_path)
    ws.init_workspace(str(ws_path))
    for name, seed in experiments.items():
        cfg_path = ws.get_config_file_path(str(ws_path), name)
        with open(cfg_path, "w") as fh:
            fh.write(text)
        cfg = load_train_config(cfg_path)
        model = AAE.from_config(cfg)
        x = jnp.zeros((1,) + cfg.shape)
        # encode-only init: serving reads only the encoder's parameters
        params = model.init({"params": jax.random.PRNGKey(seed)}, x, method=model.encode)["params"]
        n = len(view_sampler.viewsphere_rotations(cfg.min_n_views, cfg.num_cyclo, cfg.radius))
        rng = np.random.RandomState(seed)
        emb = rng.randn(n, cfg.latent_space_size).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        wh = rng.randint(20, 60, (n, 2))
        xy = np.array([64, 48]) - wh // 2 + rng.randint(-3, 4, (n, 2))
        bbs = np.concatenate([xy, wh], axis=1).astype(np.int32)
        log_dir = ws.get_log_dir(str(ws_path), name)
        CheckpointManager(ws.get_checkpoint_dir(log_dir)).save(
            step,
            {
                "params": jax.device_get(params),
                "embedding_normalized": emb,
                "embed_obj_bbs": bbs,
            },
        )
        converter.main([name])
    return str(ws_path)


def make_frames(classes, n_frames, dets_per_class, seed, hw=(96, 128)):
    """Seeded random BGR frames with `dets_per_class` boxes per class."""
    from augmentedautoencoder_torch.pose import BoundingBox

    rng = np.random.RandomState(seed)
    H, W = hw
    frames = []
    for _ in range(n_frames):
        img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        boxes = []
        for cls in classes:
            for _ in range(dets_per_class):
                w, h = rng.randint(12, 48), rng.randint(12, 48)
                x, y = rng.randint(0, W - w), rng.randint(0, H - h)
                boxes.append(
                    BoundingBox(xmin=x / W, ymin=y / H, xmax=(x + w) / W, ymax=(y + h) / H,
                                classes={cls: 0.9})
                )
        frames.append({"bboxes": boxes, "color_img": img,
                       "camK": np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])})
    return frames
