"""The port's training data (data/pipeline.py, the training side of
data/dataset.py) against the JAX package's:

  * `compose_batch` given the draws JAX's `sample_batch` makes from its key
    (re-drawn here with the same key splits): the uint8 composite with
    realistic and square occlusion and two neighbour-clutter pastes equal,
    and the augmented batch within 1e-5 on [0, 1];
  * `draw_batch`'s own draws against those draws' distribution (indices
    with and without replacement, occlusion picks and translations,
    square cells, clutter shifts, the augmentation chain), and its indices
    distinct within a batch when the pool holds a batch;
  * the shifts: `shift2d` is `translate2d` (zero fill) and `jnp.roll` (wrap);
  * the training renders of the port's threaded `Dataset` from
    RandomState(s) bit-equal to the JAX `Dataset`'s serial renders
    (`render_workers=1`, one `Renderer` built first) after np.random.seed(s);
  * the `.npz` training cache and the `.npy` background cache under one key,
    each package reading the other's; the backgrounds decoded by PIL equal
    the JAX package's cv2.imread path, resize of small images and gray
    conversion included.

The global np.random and torch RNG states are restored after every test
(`global_rng_guard`)."""

import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu.config import TrainConfig as JaxTrainConfig
from augmentedautoencoder_tpu.config import load_train_config as jax_load_train_config
from augmentedautoencoder_tpu.data import augment_spec as JS
from augmentedautoencoder_tpu.data.dataset import Dataset as JaxDataset
from augmentedautoencoder_tpu.data.occlusion_masks import synthesize_mask_bank
from augmentedautoencoder_tpu.data.pipeline import DeviceDataset as JaxDeviceDataset
from augmentedautoencoder_tpu.data.pipeline import translate2d
from augmentedautoencoder_tpu.renderer import Renderer as JaxRenderer
from augmentedautoencoder_torch.config import TrainConfig, load_train_config
from augmentedautoencoder_torch.data import augment_spec as TS
from augmentedautoencoder_torch.data.dataset import Dataset
from augmentedautoencoder_torch.data.pipeline import DeviceDataset, shift2d

from _torch_port_ws import (  # noqa: F401 (global_rng_guard: autouse)
    TINY_CFG, assert_same_draw_distribution, global_rng_guard, jax_draw, write_procedural_mesh)

torch.set_num_threads(1)

TOL = 1e-5  # augmented batch, on [0, 1]
H = 32
CODE = """Sequential([Sometimes(0.5, Affine(scale=(1.0, 1.2))), Sometimes(0.5, Add((-25, 25), per_channel=0.3)),
    Sometimes(0.5, Multiply((0.6, 1.4), per_channel=0.5)), Sometimes(0.5, GaussianBlur(0.9))])"""


def _cfgs(code, **kw):
    out = []
    for cls, spec in ((JaxTrainConfig, JS), (TrainConfig, TS)):
        cfg = cls(h=H, w=H, c=3)
        cfg.code = None if code is None else eval(code, dict(spec.DSL_CONSTRUCTORS))
        for k, v in kw.items():
            setattr(cfg, k, v)
        out.append(cfg)
    return out


def _arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (n, H, H, 3)).astype(np.uint8)
    y = rng.randint(0, 256, (n, H, H, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:H, :H]
    masks = np.ones((n, H, H), bool)  # True = background
    for i in range(n):
        cy, cx, r = rng.uniform(10, 22), rng.uniform(10, 22), rng.uniform(5, 11)
        masks[i] = (yy - cy) ** 2 + (xx - cx) ** 2 > r * r
    bg = rng.randint(0, 256, (5, H, H, 3)).astype(np.uint8)
    return x, masks, y, bg, synthesize_mask_bank(7, (H, H), seed=seed)


def jax_batch_draws(jds, rng, b):
    """The draws of the JAX `DeviceDataset.sample_batch(rng, b)`, in the
    port's `draw_batch` layout."""
    cfg, d = jds.cfg, jds.data
    n, n_bg = d.train_x.shape[0], d.bg_imgs.shape[0]
    h, w = d.train_x.shape[1:3]
    k_idx, k_bg, k_occ, k_rocc, k_aug = jax.random.split(rng, 5)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    draws = {"idcs": t(jax.random.choice(k_idx, n, (b,), replace=n < b)).long(),
             "bg_idcs": t(jax.random.choice(k_bg, n_bg, (b,), replace=n_bg < b)).long()}
    if cfg.realistic_occlusion:
        pick, ty, tx, r = [], [], [], k_rocc
        for _ in range(8):
            r, k1, k2, k3 = jax.random.split(r, 4)
            pick.append(jax.random.randint(k1, (b,), 0, d.occlusion_masks.shape[0]))
            sign = jax.random.rademacher(k2, (b, 2))
            mag = 0.2 + (0.7 - 0.2) * jax.random.uniform(k3, (b, 2))
            ty.append((sign[:, 0] * mag[:, 0] * h).astype(jnp.int32))
            tx.append((sign[:, 1] * mag[:, 1] * w).astype(jnp.int32))
        draws["rocc"] = {"pick": t(jnp.stack(pick)).long(), "ty": t(jnp.stack(ty)), "tx": t(jnp.stack(tx))}
    if cfg.square_occlusion:
        keep, apply, r = [], [], k_occ
        for _ in range(8):
            r, sub = jax.random.split(r)
            k1, k2 = jax.random.split(sub)
            keep.append(jax.random.bernoulli(k1, 0.6, (b, 1, 1)))
            apply.append(jax.random.bernoulli(k2, 0.7, (b,)))
        draws["socc"] = {"keep": t(jnp.stack(keep)), "apply": t(jnp.stack(apply))}
    if cfg.neighbor_clutter:
        lo_s, hi_s = cfg.neighbor_clutter_shift
        draws["clutter"] = []
        for j in range(max(1, int(cfg.neighbor_clutter_count))):
            off = 101 + 10 * j

            def rand_shift(k, size):
                ka, kb = jax.random.split(k)
                mag = jax.random.randint(ka, (b,), int(lo_s * size), int(hi_s * size))
                return mag * jax.random.choice(kb, jnp.array([-1, 1]), (b,))

            draws["clutter"].append({
                "nb_idcs": t(jax.random.choice(jax.random.fold_in(rng, off), n, (b,))).long(),
                "dx": t(rand_shift(jax.random.fold_in(rng, off + 1), w)),
                "dy": t(rand_shift(jax.random.fold_in(rng, off + 2), h)),
                "apply": t(jax.random.bernoulli(jax.random.fold_in(rng, off + 3), cfg.neighbor_clutter, (b,))),
            })
    draws["aug"] = jax_draw(cfg.code, k_aug, (b, h, w, 3)) if cfg.code is not None else {}
    return draws


BATCH_CASES = {
    "plain": dict(code=None, n=10),
    "small_pool": dict(code=None, n=6),  # fewer samples than the batch: drawn with replacement
    "occlusion_clutter": dict(code=None, n=10, realistic_occlusion=0.35, square_occlusion=0.3,
                              neighbor_clutter=0.7, neighbor_clutter_count=2),
    "augmented": dict(code=CODE, n=10, realistic_occlusion=0.35, neighbor_clutter=0.5),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_compose_batch_matches_jax_given_its_draws(case):
    kw = dict(BATCH_CASES[case])
    code, n = kw.pop("code"), kw.pop("n")
    jcfg, tcfg = _cfgs(code, **kw)
    x, masks, y, bg, occ = _arrays(n)
    jds = JaxDeviceDataset(jcfg, x, masks, y, bg, occlusion_masks=occ)
    tds = DeviceDataset(tcfg, x, masks, y, bg, occlusion_masks=occ, device="cpu")
    for seed in range(2):
        rng = jax.random.PRNGKey(seed + 11)
        want_x, want_y = (np.asarray(a) for a in jds.sample_batch(rng, 8))
        draws = jax_batch_draws(jds, rng, 8)
        comp, target = tds.composite(draws)
        got_x, got_y = (a.numpy() for a in tds.compose_batch(draws))
        assert comp.dtype == torch.uint8 and got_x.dtype == np.float32
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_array_equal(target.numpy(), y[draws["idcs"].numpy()])
        if code is None:  # no augmentation: the composite itself
            np.testing.assert_array_equal(comp.numpy(), np.round(want_x * 255).astype(np.uint8))
            np.testing.assert_array_equal(got_x, want_x)
        else:
            np.testing.assert_allclose(got_x, want_x, atol=TOL, rtol=0)
    # the port's own draws give a batch of the same contract
    bx, by = tds.sample_batch(torch.Generator().manual_seed(0), 8)
    assert bx.shape == by.shape == (8, H, H, 3) and 0.0 <= float(bx.min()) and float(bx.max()) <= 1.0


@pytest.mark.parametrize("n", [64, 6])
def test_draw_batch_follows_the_jax_distribution(n):
    """40 batches of 48 from each side: a pool of 64 (without replacement)
    or of 6 (with it); 5 backgrounds (with it)."""
    b, reps = 48, 40
    jcfg, tcfg = _cfgs(CODE, realistic_occlusion=0.35, square_occlusion=0.3, neighbor_clutter=0.7,
                       neighbor_clutter_count=2)
    x, masks, y, bg, occ = _arrays(n)
    jds = JaxDeviceDataset(jcfg, x, masks, y, bg, occlusion_masks=occ)
    tds = DeviceDataset(tcfg, x, masks, y, bg, occlusion_masks=occ, device="cpu")
    gen = torch.Generator().manual_seed(9)
    port = [tds.draw_batch(gen, b) for _ in range(reps)]
    ref = [jax_batch_draws(jds, jax.random.PRNGKey(100 + r), b) for r in range(reps)]
    if n >= b:
        for d in port + ref:
            assert len(set(d["idcs"].tolist())) == b
    assert_same_draw_distribution(port, ref)


def test_shift2d_is_translate2d_and_roll():
    rng = np.random.RandomState(3)
    imgs = rng.rand(6, 9, 7) > 0.5
    dy = np.array([0, 3, -4, 8, -8, 2], np.int32)
    dx = np.array([1, -6, 6, 0, -1, 7], np.int32)
    want = np.stack([np.asarray(translate2d(jnp.asarray(a), int(a_), int(b_))) for a, a_, b_ in zip(imgs, dy, dx)])
    got = shift2d(torch.from_numpy(imgs), torch.from_numpy(dy), torch.from_numpy(dx), wrap=False).numpy()
    np.testing.assert_array_equal(got, want)
    col = rng.randint(0, 256, (6, 9, 7, 3)).astype(np.uint8)
    want = np.stack([np.roll(a, (int(a_), int(b_)), axis=(0, 1)) for a, a_, b_ in zip(col, dy, dx)])
    np.testing.assert_array_equal(shift2d(torch.from_numpy(col), torch.from_numpy(dy), torch.from_numpy(dx),
                                          wrap=True).numpy(), want)


# ------------------------------------------------------------------ renders and caches

@pytest.fixture(scope="module")
def render_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline")
    ply = write_procedural_mesh(root / "obj.ply")
    bg_dir = root / "bg"
    bg_dir.mkdir()
    rng = np.random.RandomState(5)
    for i, (h, w) in enumerate([(40, 50), (20, 45), (33, 33), (60, 31), (48, 48), (25, 70)]):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        cv2.imwrite(str(bg_dir / f"{i}.png"), img)
    text = (TINY_CFG.replace("/nonexistent/model.ply", ply)
            .replace("/nonexistent/*.jpg", str(bg_dir / "*.png"))
            .replace("NOOF_TRAINING_IMGS: 4", "NOOF_TRAINING_IMGS: 6")
            .replace("NOOF_BG_IMGS: 0", "NOOF_BG_IMGS: 5"))
    paths = {}
    for c in (3, 1):
        paths[c] = str(root / f"c{c}.cfg")
        with open(paths[c], "w") as fh:
            fh.write(text.replace("C: 3", f"C: {c}"))
    return root, paths


def _jax_dataset(root, cfg_path, sub):
    cfg = jax_load_train_config(cfg_path)
    renderer = JaxRenderer([cfg.model_path], samples=cfg.antialiasing, vertex_tmp_store_folder=str(root),
                           vertex_scale=cfg.vertex_scale, backend="native")
    return JaxDataset(str(root / sub), cfg, renderer=renderer, render_workers=1)


@pytest.mark.parametrize("channels", [3, 1])
def test_training_renders_and_cache_match_jax(render_cfg, channels):
    root, paths = render_cfg
    jds = _jax_dataset(root, paths[channels], "jax")
    np.random.seed(17)  # the JAX package draws from the global stream; global_rng_guard restores it
    jds.get_training_images(str(root / f"jax{channels}"), progress=False)  # renders serially, writes the cache
    tds = Dataset(str(root / "port"), load_train_config(paths[channels]), render_workers=3)
    tds.get_training_images(str(root / f"port{channels}"), np.random.RandomState(17), progress=False)
    for name in ("train_x", "mask_x", "train_y", "noof_obj_pixels"):
        np.testing.assert_array_equal(getattr(tds, name), getattr(jds, name), err_msg=name)
    assert tds.train_x.shape == (6, 32, 32, channels) and tds.mask_x.dtype == bool
    assert 0 < tds.noof_obj_pixels.min()
    # one key: each package reads the other's cache (no rendering: the rng is not drawn from)
    names = sorted(f for f in os.listdir(root / f"port{channels}") if f.endswith(".npz"))
    assert names == sorted(f for f in os.listdir(root / f"jax{channels}") if f.endswith(".npz"))
    rs = np.random.RandomState(0)
    cross = Dataset(str(root / "port"), load_train_config(paths[channels]))
    cross.get_training_images(str(root / f"jax{channels}"), rs, progress=False)
    assert rs.randint(1 << 30) == np.random.RandomState(0).randint(1 << 30)
    jcross = _jax_dataset(root, paths[channels], "jax")
    jcross.get_training_images(str(root / f"port{channels}"), progress=False)
    for name in ("train_x", "mask_x", "train_y"):
        np.testing.assert_array_equal(getattr(cross, name), getattr(jds, name))
        np.testing.assert_array_equal(getattr(jcross, name), getattr(tds, name))


@pytest.mark.parametrize("channels", [3, 1])
def test_backgrounds_match_jax_and_share_the_cache(render_cfg, channels):
    root, paths = render_cfg
    jds = _jax_dataset(root, paths[channels], "jax")
    np.random.seed(23)
    jds.load_bg_images(str(root / f"bgjax{channels}"))
    tds = Dataset(str(root / "port"), load_train_config(paths[channels]))
    tds.load_bg_images(str(root / f"bgport{channels}"), np.random.RandomState(23))
    assert tds.bg_imgs.shape == (5, 32, 32, channels)
    np.testing.assert_array_equal(tds.bg_imgs, jds.bg_imgs)
    assert os.listdir(root / f"bgport{channels}") == os.listdir(root / f"bgjax{channels}")
    again = Dataset(str(root / "port"), load_train_config(paths[channels]))
    again.load_bg_images(str(root / f"bgjax{channels}"), np.random.RandomState(0))
    np.testing.assert_array_equal(again.bg_imgs, jds.bg_imgs)


def test_jpeg_decode_equals_cv2(tmp_path):
    from augmentedautoencoder_torch.data.dataset import decode_bgr

    rng = np.random.RandomState(1)
    img = cv2.GaussianBlur(rng.randint(0, 256, (37, 53, 3)).astype(np.uint8), (5, 5), 0)
    for name, extra in (("a.jpg", [cv2.IMWRITE_JPEG_QUALITY, 90]), ("b.png", [])):
        cv2.imwrite(str(tmp_path / name), img, extra)
        np.testing.assert_array_equal(decode_bgr(str(tmp_path / name)), cv2.imread(str(tmp_path / name)))
    cv2.imwrite(str(tmp_path / "g.jpg"), img[:, :, 0])  # a gray file reads as 3 channels
    np.testing.assert_array_equal(decode_bgr(str(tmp_path / "g.jpg")), cv2.imread(str(tmp_path / "g.jpg")))


def test_backgrounds_without_cache_or_pil_name_the_cache(render_cfg, monkeypatch):
    root, paths = render_cfg
    tds = Dataset(str(root / "port"), load_train_config(paths[3]))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(FileNotFoundError, match=os.path.basename(tds.bg_cache_file(str(root / "none")))):
        tds.load_bg_images(str(root / "none"), np.random.RandomState(0))


def test_device_dataset_refuses_no_backgrounds():
    _, tcfg = _cfgs(None)
    x, masks, y, _, _ = _arrays(4)
    with pytest.raises(ValueError, match="background"):
        DeviceDataset(tcfg, x, masks, y, np.zeros((0, H, H, 3), np.uint8))
