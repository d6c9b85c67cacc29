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
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_converter():
    """scripts/convert_jax_checkpoint.py as a module (scripts/ is no package)."""
    path = os.path.join(REPO, "scripts", "convert_jax_checkpoint.py")
    spec = importlib.util.spec_from_file_location("convert_jax_checkpoint", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

@pytest.fixture(autouse=True)
def global_rng_guard():
    """Restores the global np.random and torch RNG states after each test
    of a module that imports this fixture (building a torch module draws
    its default initialization from the global torch RNG)."""
    import torch

    np_state, torch_state = np.random.get_state(), torch.random.get_rng_state()
    yield
    np.random.set_state(np_state)
    torch.random.set_rng_state(torch_state)


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

DSPRITES_LATENT_SIZES = (1, 3, 6, 40, 32, 32)  # color, shape, scale, orientation, posX, posY


def write_dsprites_npz(path, hw=8, seed=0):
    """A dsprites-format .npz with the real latent grid (737,280 images) and
    seeded binary `hw` x `hw` images (tests/test_aux.py's layout)."""
    sizes = np.array(DSPRITES_LATENT_SIZES)
    n = int(sizes.prod())
    imgs = np.random.RandomState(seed).randint(0, 2, (n, hw, hw), dtype=np.uint8)
    grids = np.meshgrid(*[np.arange(s) for s in sizes], indexing="ij")
    latents_classes = np.stack([g.reshape(-1) for g in grids], axis=1)
    np.savez(str(path), imgs=imgs, latents_classes=latents_classes,
             latents_values=latents_classes.astype(np.float32), metadata=np.array({"latents_sizes": sizes}))
    return str(path)


def dsprites_cfg(npz_path, hw=8, num_iter=4, save_interval=2, batch_size=8):
    """TINY_CFG as a MODEL dsprites experiment on `npz_path`: `hw` x `hw` x 1
    inputs, latent 8, no augmentation, no boxes in the codebook."""
    text = (TINY_CFG.replace("MODEL: reconst", "MODEL: dsprites")
            .replace("MODEL_PATH: /nonexistent/model.ply", f"MODEL_PATH: {npz_path}")
            .replace("H: 32", f"H: {hw}").replace("W: 32", f"W: {hw}").replace("C: 3", "C: 1")
            .replace("EMBED_BB: True", "EMBED_BB: False").replace("MIN_N_VIEWS: 12", "MIN_N_VIEWS: 40")
            .replace("NUM_CYCLO: 4", "NUM_CYCLO: 1").replace("LATENT_SPACE_SIZE: 16", "LATENT_SPACE_SIZE: 8")
            .replace("NUM_ITER: 10", f"NUM_ITER: {num_iter}").replace("SAVE_INTERVAL: 10", f"SAVE_INTERVAL: {save_interval}")
            .replace("BATCH_SIZE: 8", f"BATCH_SIZE: {batch_size}"))
    lines = text.splitlines()
    i = next(k for k, line in enumerate(lines) if line.startswith("CODE:"))
    lines[i] = "CODE: Sequential([])"
    return "\n".join(lines) + "\n"


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


def jax_aae_variables(model, hw, seed):
    """Flax variables of a JAX `AAE` (decoder included) from `model.init`
    with a fixed key, as nested dicts of numpy arrays, with non-trivial
    BatchNorm scales, biases and running statistics and a non-zero VAE
    sigma kernel, drawn from np.random.RandomState(seed)."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((1,) + tuple(hw))
    variables = jax.tree.map(np.array, dict(model.init({"params": jax.random.PRNGKey(seed)}, x, x)))
    rng = np.random.RandomState(seed)
    for scope, stats in variables.get("batch_stats", {}).items():
        for name, s in stats.items():
            s["mean"] = (rng.randn(*s["mean"].shape) * 0.1).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
            p = variables["params"][scope][name]
            p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
            p["bias"] = (rng.randn(*p["bias"].shape) * 0.1).astype(np.float32)
    enc = variables["params"]["encoder"]
    if "latent_sigma" in enc:
        enc["latent_sigma"]["kernel"] = (rng.randn(*enc["latent_sigma"]["kernel"].shape) * 0.05).astype(np.float32)
    return variables


def port_aae(variables, decoder=True, **kw):
    """The port's AAE with `kw` dims, loaded from Flax `variables`."""
    from augmentedautoencoder_torch.convert import params_from_jax
    from augmentedautoencoder_torch.models import AAE

    model = AAE(decoder=decoder, **kw)
    model.load_state_dict(params_from_jax(variables["params"], variables.get("batch_stats"), decoder=decoder))
    return model


def jax_draw(spec, rng, shape):
    """The parameters the JAX augmentation op or combinator `spec` draws
    from `rng` for a batch of `shape` (augmentedautoencoder_tpu/data/augment.py's
    key splits), in the layout of the port's `Augmenter.draw`."""
    import jax
    import jax.numpy as jnp
    import torch

    from augmentedautoencoder_tpu.data import augment as ja
    from augmentedautoencoder_tpu.data import augment_spec as JS

    def _t(a):
        return torch.from_numpy(np.array(a))

    b, h, w, c = shape
    bern, unif = jax.random.bernoulli, jax.random.uniform
    if isinstance(spec, JS.Noop):
        return {}
    if isinstance(spec, JS.Sequential):
        if spec.random_order:
            n = len(spec.children)
            kperm, *kops = jax.random.split(rng, n + 1)
            perm = [int(i) for i in jax.random.permutation(kperm, n)]
            return {"perm": perm, "steps": [jax_draw(spec.children[i], kops[j], shape) for j, i in enumerate(perm)]}
        out = []
        for child in spec.children:
            rng, sub = jax.random.split(rng)
            out.append(jax_draw(child, sub, shape))
        return out
    if isinstance(spec, JS.Sometimes):
        k1, k2 = jax.random.split(rng)
        return {"apply": _t(bern(k1, float(spec.p), (b, 1, 1, 1))), "child": jax_draw(spec.child, k2, shape)}
    if isinstance(spec, JS.OneOf):
        n = len(spec.children)
        keys = jax.random.split(rng, n + 1)
        return {"choice": _t(jax.random.randint(keys[0], (b, 1, 1, 1), 0, n)).long(),
                "children": [jax_draw(ch, keys[i + 1], shape) for i, ch in enumerate(spec.children)]}
    if isinstance(spec, JS.Affine):
        lo, hi = JS.as_range(spec.scale)
        return {"scales": _t(unif(rng, (b,), minval=lo, maxval=hi))}
    if isinstance(spec, (JS.CoarseDropout, JS.Dropout)):
        cells = (b, max(1, int(round(h * spec.size_percent))), max(1, int(round(w * spec.size_percent)))) \
            if isinstance(spec, JS.CoarseDropout) else (b, h, w)
        k1, k2, k3 = jax.random.split(rng, 3)
        keep = bern(k1, 1.0 - spec.p, cells + (1,))
        if isinstance(spec, JS.Dropout) and spec.per_channel >= 1.0:
            keep = bern(k2, 1.0 - spec.p, cells + (c,))
        elif spec.per_channel > 0.0:
            keep = jnp.where(bern(k3, spec.per_channel, (b, 1, 1, 1)), bern(k2, 1.0 - spec.p, cells + (c,)), keep)
        return {"keep": _t(keep)}
    if isinstance(spec, JS.GaussianBlur):
        lo, hi = JS.as_range(spec.sigma)
        return {} if hi < 1e-3 or lo == hi else {"sigmas": _t(unif(rng, (b,), minval=lo, maxval=hi))}
    if isinstance(spec, JS.Add):
        lo, hi = JS.as_range(spec.value)
        discrete = float(lo).is_integer() and float(hi).is_integer()
        return {"value": _t(ja._per_image_param(rng, b, c, lo, hi, spec.per_channel, discrete=discrete))}
    if isinstance(spec, JS.AdditiveGaussianNoise):
        lo, hi = JS.as_range(spec.scale)
        k1, k2, k3, k4 = jax.random.split(rng, 4)
        scale = unif(k1, (b, 1, 1, 1), minval=lo, maxval=hi)
        noise = jax.random.normal(k2, (b, h, w, c if spec.per_channel >= 1.0 else 1)) * scale + spec.loc
        if 0.0 < spec.per_channel < 1.0:
            noise_pc = jax.random.normal(k3, (b, h, w, c)) * scale + spec.loc
            noise = jnp.where(bern(k4, spec.per_channel, (b, 1, 1, 1)), noise_pc, jnp.broadcast_to(noise, (b, h, w, c)))
        return {"noise": _t(noise)}
    if isinstance(spec, JS.Multiply):
        lo, hi = JS.as_range(spec.mul)
        return {"mul": _t(ja._per_image_param(rng, b, c, lo, hi, spec.per_channel))}
    if isinstance(spec, JS.ContrastNormalization):
        lo, hi = JS.as_range(spec.alpha)
        return {"alpha": _t(ja._per_image_param(rng, b, c, lo, hi, spec.per_channel))}
    if isinstance(spec, JS.Invert):
        k1, k2, k3 = jax.random.split(rng, 3)
        inv = bern(k1, spec.p, (b, 1, 1, 1))
        if spec.per_channel > 0.0:
            inv = jnp.where(bern(k3, spec.per_channel, (b, 1, 1, 1)), bern(k2, spec.p, (b, 1, 1, c)), inv)
        return {"invert": _t(inv)}
    if isinstance(spec, (JS.Fliplr, JS.Flipud)):
        return {"flip": _t(bern(rng, spec.p, (b, 1, 1, 1)))}
    if isinstance(spec, JS.Grayscale):
        lo, hi = JS.as_range(spec.alpha)
        return {"alpha": _t(unif(rng, (b, 1, 1, 1), minval=lo, maxval=hi))}
    raise NotImplementedError(type(spec).__name__)


def _draw_leaves(p, path=""):
    """Flatten nested draws into {path: numpy array}; a random order
    {"perm", "steps"} becomes its one-hot (1, n, n) position-by-child
    matrix and the steps in child order, so that draws in other orders
    line up."""
    import torch

    if isinstance(p, dict) and "perm" in p:
        n = len(p["perm"])
        onehot = np.zeros((1, n, n), bool)
        onehot[0, np.arange(n), p["perm"]] = True
        out = {f"{path}/perm": onehot}
        for i in range(n):
            out.update(_draw_leaves(p["steps"][p["perm"].index(i)], f"{path}/child{i}"))
        return out
    if isinstance(p, dict):
        out = {}
        for k in sorted(p):
            out.update(_draw_leaves(p[k], f"{path}/{k}"))
        return out
    if isinstance(p, list):
        out = {}
        for i, v in enumerate(p):
            out.update(_draw_leaves(v, f"{path}/{i}"))
        return out
    assert isinstance(p, torch.Tensor), (path, type(p))
    return {path: p.cpu().numpy()}


def assert_same_draw_distribution(port_draws, jax_draws, z=6.0, ks_p=1e-6, rel_span=0.02):
    """Hold the port's random draws against the JAX package's: two lists of
    independent draws in the port's layout (Augmenter.draw,
    DeviceDataset.draw_batch). Each leaf's draws are stacked into units
    along its first axis (an image, or an occlusion attempt) and compared:

      * each element's mean over the units, where a unit holds at most 64
        (frequencies of Bernoulli draws, one-hot permutations), and each
        unit's mean and spread, within `z` standard errors;
      * the per-unit means' distributions by a two-sample Kolmogorov-Smirnov
        test (p >= `ks_p`);
      * with 3 channels last, the share of positions equal across channels
        (imgaug's per_channel share), within `z` standard errors;
      * the values drawn: the same set where they are integers (inclusive
        or exclusive bounds), with 3 channels last also apart for the
        positions equal across channels and the others, else minimum and
        maximum within `rel_span` of the range (not for Gaussian noise,
        which has none).

    The draws are deterministic (seeded), so a pass stays a pass."""
    from scipy.stats import ks_2samp

    def stack(draws):
        leaves = [_draw_leaves(d) for d in draws]
        return {k: np.concatenate([leaf[k] for leaf in leaves]) for k in leaves[0]}

    port, ref = stack(port_draws), stack(jax_draws)
    assert set(port) == set(ref), (sorted(port), sorted(ref))

    def close(name, a, b):
        """Means of the unit samples a, b (U, ...) agree, elementwise."""
        a, b = a.astype(np.float64), b.astype(np.float64)
        se = np.sqrt(a.var(0) / len(a) + b.var(0) / len(b))
        gap = np.abs(a.mean(0) - b.mean(0))
        assert np.all(gap <= z * se + 1e-9), (name, a.mean(0), b.mean(0), se)

    for key in sorted(port):
        a, b = port[key], ref[key]
        assert a.shape[1:] == b.shape[1:] and a.dtype.kind == b.dtype.kind, (key, a.shape, b.shape, a.dtype, b.dtype)
        ua, ub = a.reshape(len(a), -1).astype(np.float64), b.reshape(len(b), -1).astype(np.float64)
        if ua.shape[1] <= 64:
            close(f"{key} elementwise", ua, ub)
        close(f"{key} per-unit mean", ua.mean(1), ub.mean(1))
        if ua.shape[1] > 1:
            close(f"{key} per-unit spread", ua.std(1), ub.std(1))
        ks = ks_2samp(ua.mean(1), ub.mean(1), method="asymp")
        assert ks.pvalue >= ks_p, (key, ks)
        if a.ndim >= 2 and a.shape[-1] == 3:
            close(f"{key} channel-equal share", (a == a[..., :1]).all(-1).reshape(len(a), -1).mean(1),
                  (b == b[..., :1]).all(-1).reshape(len(b), -1).mean(1))
        if a.dtype.kind in "biu" or (np.all(a == np.round(a)) and np.all(b == np.round(b))):
            assert set(np.unique(a).tolist()) == set(np.unique(b).tolist()), (key, np.unique(a), np.unique(b))
            if a.ndim >= 2 and a.shape[-1] == 3:
                # the shared and the per-channel draws' values apart
                eq_a, eq_b = (a == a[..., :1]).all(-1), (b == b[..., :1]).all(-1)
                for part_a, part_b in ((a[eq_a], b[eq_b]), (a[~eq_a], b[~eq_b])):
                    assert set(np.unique(part_a).tolist()) == set(np.unique(part_b).tolist()), key
        elif not key.endswith("/noise"):
            span = max(float(b.max() - b.min()), 1e-12)
            assert abs(float(a.min() - b.min())) <= rel_span * span, (key, a.min(), b.min())
            assert abs(float(a.max() - b.max())) <= rel_span * span, (key, a.max(), b.max())


# ------------------------------------------------------------------ evaluation
EVAL_K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
EVAL_HW = (96, 128)

EVAL_CFG = textwrap.dedent(
    """
    [METHOD]
    METHOD: aae
    [DATA]
    DATASET: synth
    DATASET_PATH: {dataset_path}
    OBJ_ID: 1
    SCENES: [1]
    CAM_TYPE:
    [BBOXES]
    ESTIMATE_BBS: False
    SINGLE_INSTANCE: True
    ICP: False
    [EVALUATION]
    COMPUTE_ERRORS: True
    EVALUATE_ERRORS: True
    [METRIC]
    ERROR_TYPES: ['vsd', 're', 'te', 'add', 'adi', 'proj']
    VSD_DELTA: 15
    VSD_TAU: 20
    VSD_COST: step
    ERROR_THRESH: 0.3
    ERROR_THRESH_DEG: 15
    ERROR_THRESH_MM: 20
    TOP_N_EVAL: 1
    TOP_N: 1
    [PLOT]
    COMPUTE_PLOTS: False
    """
)


def off_centre_rotation(R_view, t):
    """The rotation at which an object at translation t looks as the
    centred view R_view does: the codebook's off-centre correction
    (`Codebook._solve_6d`) applied to R_view."""
    d_ay = np.arctan(t[0] / np.sqrt(t[2] ** 2 + t[1] ** 2))
    d_ax = -np.arctan(t[1] / t[2])
    ca, sa, cb, sb = np.cos(d_ax), np.sin(d_ax), np.cos(d_ay), np.sin(d_ay)
    R_x = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    R_y = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    return R_y @ R_x @ R_view


def eval_scene_poses(n_images=3, instances=2, seed=0):
    """(poses, rows): per image [(R, t)] at 300-330 mm, laterally apart,
    each R a codebook view (TINY_CFG's view sphere, distinct rows) turned
    by `off_centre_rotation` for its t, and the view-sphere row of each
    instance."""
    from augmentedautoencoder_torch.geometry.view_sampler import viewsphere_rotations

    views = viewsphere_rotations(12, 4, 300.0)
    rng = np.random.RandomState(seed)
    rows = rng.choice(len(views), (n_images, instances), replace=False)
    offsets = np.linspace(-30.0, 30.0, instances) if instances > 1 else [0.0]
    poses = []
    for rs in rows:
        ts = [np.array([tx, rng.uniform(-8, 8), rng.uniform(300, 330)]) for tx in offsets]
        poses.append([(off_centre_rotation(views[r], t), t) for r, t in zip(rs, ts)])
    return poses, rows


def make_eval_workspace(root, poses=None, rows=None, decoder=True, step=10, seed=3):
    """A workspace with experiment "obj" at TINY_CFG's width whose MODEL_PATH
    is a procedural textured mesh, and with `poses` (eval_scene_poses) its
    BOP scene under root/data (write_bop_scene). Flax parameters (with the
    decoder unless `decoder` is False) from a fixed key; the codebook holds
    the JAX encoder's codes of the JAX package's renders of every view,
    except that each scene instance's `rows` entry holds the code of its
    GT-box crop, so the evaluation retrieves its GT rotation. Saved as a
    JAX checkpoint and as the port's `.pt` (both read the same rows). Sets
    AE_WORKSPACE_PATH; returns (workspace path, mesh path, dataset root)."""
    import json

    import jax
    import jax.numpy as jnp

    from augmentedautoencoder_tpu import workspace as jws
    from augmentedautoencoder_tpu.config import load_train_config
    from augmentedautoencoder_tpu.data.dataset import Dataset as JaxDataset
    from augmentedautoencoder_tpu.models import AAE as JaxAAE
    from augmentedautoencoder_tpu.training.checkpoint import CheckpointManager as JaxCheckpoints
    from augmentedautoencoder_torch.convert import params_from_jax
    from augmentedautoencoder_torch.data.dataset import extract_square_patch
    from augmentedautoencoder_torch.training.checkpoint import CheckpointManager
    from augmentedautoencoder_torch.utils.png import read_png

    root = str(root)
    ply = write_procedural_mesh(os.path.join(root, "obj.ply"), subdivisions=2, radius=45.0)
    ws_path = os.path.join(root, "workspace")
    os.environ[jws.WORKSPACE_ENV_VAR] = ws_path
    jws.init_workspace(ws_path)
    cfg_path = jws.get_config_file_path(ws_path, "obj")
    with open(cfg_path, "w") as fh:
        fh.write(TINY_CFG.replace("MODEL_PATH: /nonexistent/model.ply", f"MODEL_PATH: {ply}"))
    cfg = load_train_config(cfg_path)
    model = JaxAAE.from_config(cfg)
    x = jnp.zeros((1,) + cfg.shape)
    key = {"params": jax.random.PRNGKey(seed)}
    params = (model.init(key, x, x) if decoder else model.init(key, x, method=model.encode))["params"]
    params = jax.tree.map(np.array, params)

    def encode(crops):
        z = np.asarray(model.apply({"params": params}, jnp.asarray(crops, jnp.float32) / 255.0, method=model.encode))
        return (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.float32)

    dataset_path = jws.get_dataset_path(ws_path)
    ds = JaxDataset(dataset_path, cfg, render_workers=1)
    ds.renderer  # built before any render
    crops, bbs = ds.render_embedding_image_batch(0, ds.embedding_size)
    emb, bbs = encode(crops), bbs.astype(np.int32)
    data_root = os.path.join(root, "data")
    if poses is not None:
        scene_dir = write_bop_scene(data_root, ply, poses)
        with open(os.path.join(scene_dir, "scene_gt_info.json")) as fh:
            info = json.load(fh)
        for i, rs in enumerate(rows):
            img = read_png(os.path.join(scene_dir, "rgb", f"{i:06d}.png"))
            for m, r in enumerate(rs):
                crop = extract_square_patch(img, info[str(i)][m]["bbox_obj"], cfg.pad_factor, resize=(cfg.w, cfg.h))
                emb[r] = encode(crop[None])[0]
    ckpt_dir = jws.get_checkpoint_dir(jws.get_log_dir(ws_path, "obj"))
    JaxCheckpoints(ckpt_dir).save(step, {"params": params, "embedding_normalized": emb, "embed_obj_bbs": bbs})
    CheckpointManager(ckpt_dir).save(step, params_from_jax(params, None, decoder=decoder), emb, bbs)
    return ws_path, ply, data_root


def write_bop_scene(dataset_root, ply, poses, K=EVAL_K, hw=EVAL_HW, writer="port", bbox=True):
    """One BOP scene (test/000001) of `poses` (per image [(R, t)], obj_id 1)
    rendered by the port's native rasterizer: rgb, 16-bit depth (mm),
    mask_visib, scene_gt, scene_camera and scene_gt_info (bbox_obj unless
    `bbox` is False, bbox_visib, visib_fract), written by the port's PNG
    writer or by cv2 (`writer`). Returns the scene dir."""
    import json

    from augmentedautoencoder_torch.renderer import Renderer, load_mesh
    from augmentedautoencoder_torch.utils.png import write_png

    if writer == "cv2":
        import cv2

        def write(path, img):
            assert cv2.imwrite(path, img)
    else:
        write = write_png
    H, W = hw
    renderer = Renderer([], backend="native", meshes=[load_mesh(ply)])
    scene_dir = os.path.join(str(dataset_root), "test", "000001")
    for sub in ("rgb", "depth", "mask_visib"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
    gt, cam, gt_info = {}, {}, {}
    for i, insts in enumerate(poses):
        bgr = np.zeros((H, W, 3), np.uint8)
        depth = np.zeros((H, W), np.float32)
        inst_depths = []
        for R, t in insts:
            bgr_m, depth_m = renderer.render(0, W, H, K, R, t, 10, 10000, random_light=False)
            vis = (depth_m > 0) & ((depth == 0) | (depth_m < depth))
            bgr[vis] = bgr_m[vis]
            depth[vis] = depth_m[vis]
            inst_depths.append(depth_m)
        infos = []
        for m, depth_m in enumerate(inst_depths):
            vis_m = (depth_m > 0) & (depth == depth_m)
            write(os.path.join(scene_dir, "mask_visib", f"{i:06d}_{m:06d}.png"), vis_m.astype(np.uint8) * 255)
            info = {"visib_fract": float(vis_m.sum() / max((depth_m > 0).sum(), 1))}
            for key, mask_m in (("bbox_obj", depth_m > 0), ("bbox_visib", vis_m)):
                ys, xs = np.nonzero(mask_m)
                info[key] = ([int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                              int(ys.max() - ys.min() + 1)] if len(xs) else None)
            if not bbox:
                del info["bbox_obj"]
            infos.append(info)
        gt_info[str(i)] = infos
        write(os.path.join(scene_dir, "rgb", f"{i:06d}.png"), bgr)
        write(os.path.join(scene_dir, "depth", f"{i:06d}.png"), np.round(depth).astype(np.uint16))
        gt[str(i)] = [{"obj_id": 1, "cam_R_m2c": np.asarray(R).ravel().tolist(), "cam_t_m2c": np.asarray(t).tolist()}
                      for R, t in insts]
        cam[str(i)] = {"cam_K": np.asarray(K).ravel().tolist(), "depth_scale": 1.0}
    for name, data in (("scene_gt", gt), ("scene_camera", cam), ("scene_gt_info", gt_info)):
        with open(os.path.join(scene_dir, f"{name}.json"), "w") as fh:
            json.dump(data, fh)
    return scene_dir
