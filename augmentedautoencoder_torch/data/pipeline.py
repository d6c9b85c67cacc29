"""The device-resident training data pipeline (port of
augmentedautoencoder_tpu/data/pipeline.py).

The rendered arrays live on the device once, as uint8 (and bool masks), and
one batch is

  gather (x, mask, y) triplets -> optional realistic / square occlusion of
  the mask -> neighbour clutter pasted into the background -> background
  substitution through the mask -> augmentation chain -> [0, 1] f32

as the JAX package's `DeviceDataset.sample_batch` (reference
Dataset.batch, dataset.py:456-495). It is split in two: `draw_batch(gen,
B)` draws every index, shift and mask parameter as tensors from a
`torch.Generator` on the device, and `compose_batch(draws)` computes the
batch from them deterministically, so the JAX package's draws can be fed
to it and compared.

A multi-path model's pool holds every object's renders, object after
object, each NOOF_TRAINING_IMGS rows (`n_objects`), and a batch is
stratified: B / n_o rows of each object's pool, in object order, drawn at
once for every object (`_stratified`); the backgrounds, occlusion,
clutter and augmentation draws are the one-object batch's, row by row.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import shard_range
from .augment import _bernoulli, _cells, build_augmenter, upsample_cells

#: bounded retries of the occlusion loops, as in the JAX package (the
#: reference retries without bound, dataset.py:445-454)
OCCLUSION_RETRIES = 8
#: Sometimes(0.7, CoarseDropout(p=0.4, size_percent=0.01)) of the reference's
#: square occlusion (_aug_occl, dataset.py:392-402)
SQUARE_P, SQUARE_SIZE_PERCENT, SQUARE_SOMETIMES = 0.4, 0.01, 0.7
#: translation range of the realistic occluders, relative to the crop
MIN_TRANS, MAX_TRANS = 0.2, 0.7


def shift2d(imgs: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, wrap: bool) -> torch.Tensor:
    """Shift each image of (N, H, W[, C]) by integer (dy[n], dx[n]): out[y, x]
    = img[y - dy, x - dx], either zero-filled (the JAX package's
    `translate2d`, cv2.warpAffine translation) or wrapped around
    (`jnp.roll`)."""
    n, h, w = imgs.shape[:3]
    rows = torch.arange(h, device=imgs.device)[None, :] - dy.long()[:, None]
    cols = torch.arange(w, device=imgs.device)[None, :] - dx.long()[:, None]
    if wrap:
        rows, cols = rows % h, cols % w
    out = imgs[
        torch.arange(n, device=imgs.device)[:, None, None],
        rows.clamp(0, h - 1)[:, :, None],
        cols.clamp(0, w - 1)[:, None, :],
    ]
    if not wrap:
        valid = ((rows >= 0) & (rows < h))[:, :, None] & ((cols >= 0) & (cols < w))[:, None, :]
        out = out * valid.view(valid.shape + (1,) * (imgs.dim() - 3))
    return out


def _first_ok(ok: torch.Tensor, cand: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """Per image, the candidate of the first retry whose `ok` (R, B) holds,
    else `fallback` (the JAX loops' `take = ok & ~done`)."""
    first = torch.argmax(ok.to(torch.uint8), dim=0)  # first True (0 when none)
    pick = cand[first, torch.arange(ok.shape[1], device=ok.device)]
    return torch.where(ok.any(dim=0)[:, None, None], pick, fallback)


def realistic_occlusion(masks, occluders, draws, max_occl: float, min_occl: float = 0.0) -> torch.Tensor:
    """Overlay translated occluder silhouettes (reference
    augment_occlusion_mask, dataset.py:421-444): per image the first retry
    whose occluded share of the object lies in (min_occl, max_occl) turns
    those object pixels into background. masks (B, H, W) bool, True =
    background; draws {"pick", "ty", "tx"}, each (R, B)."""
    r, b = draws["pick"].shape
    obj = ~masks
    obj_count = torch.clamp(obj.sum(dim=(1, 2)).float(), min=1.0)
    occ = occluders[draws["pick"].reshape(-1)]
    occ_t = shift2d(occ, draws["ty"].reshape(-1), draws["tx"].reshape(-1), wrap=False).view(r, b, *masks.shape[1:])
    frac = (obj[None] & occ_t).sum(dim=(2, 3)).float() / obj_count
    ok = (frac < max_occl) & (frac > min_occl)
    return ~_first_ok(ok, obj[None] & ~occ_t, obj)


def square_occlusion(masks, noof_obj_pixels, draws, max_occl: float) -> torch.Tensor:
    """Drop coarse cells of the object, keeping >= 1 - max_occl of its
    original pixels visible (dataset.py:445-454): per image the first retry
    that does. draws {"keep": (R, B, gh, gw) bool, "apply": (R, B) bool}."""
    h, w = masks.shape[1:]
    obj0 = ~masks
    orig = torch.clamp(noof_obj_pixels.float(), min=1.0)
    keep = upsample_cells(draws["keep"].flatten(0, 1), h, w).view(draws["keep"].shape[:2] + (h, w))
    cand = torch.where(draws["apply"][:, :, None, None], obj0[None] & keep, obj0[None])
    ok = cand.sum(dim=(2, 3)).float() / orig >= (1.0 - max_occl)
    return ~_first_ok(ok, cand, obj0)


def _rows(params, rows: slice):
    """An augmenter's params with each tensor cut to `rows` of its leading
    (batch) axis; other leaves (a random order's child indices) kept."""
    if isinstance(params, dict):
        return {k: _rows(v, rows) for k, v in params.items()}
    if isinstance(params, list):
        return [_rows(v, rows) for v in params]
    return params[rows] if torch.is_tensor(params) else params


def slice_draws(draws: Dict, start: int, stop: int) -> Dict:
    """`draw_batch`'s draws of batch rows [start, stop) (the occlusion
    retries keep their leading axis)."""
    rows = slice(start, stop)
    out = {"idcs": draws["idcs"][rows], "bg_idcs": draws["bg_idcs"][rows], "aug": _rows(draws["aug"], rows)}
    for key in ("rocc", "socc"):
        if key in draws:
            out[key] = {k: v[:, rows] for k, v in draws[key].items()}
    if "clutter" in draws:
        out["clutter"] = [_rows(paste, rows) for paste in draws["clutter"]]
    return out


class DeviceDataset:
    """The rendered arrays on `device` and the batch sampler."""

    def __init__(
        self,
        cfg,
        train_x: np.ndarray,
        mask_x: np.ndarray,
        train_y: np.ndarray,
        bg_imgs: np.ndarray,
        noof_obj_pixels: Optional[np.ndarray] = None,
        occlusion_masks: Optional[np.ndarray] = None,
        device="cpu",
        n_objects: int = 1,
    ):
        if len(bg_imgs) == 0:
            raise ValueError("no background images: check BACKGROUND_IMAGES_GLOB and NOOF_BG_IMGS")
        if len(train_x) % n_objects:
            raise ValueError(f"{len(train_x)} training rows do not split into {n_objects} equal object pools")
        self.n_objects = n_objects
        self.cfg = cfg
        self.device = torch.device(device)
        if noof_obj_pixels is None:
            noof_obj_pixels = np.count_nonzero(np.asarray(mask_x) == 0, axis=(1, 2))

        def put(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=self.device, dtype=dtype)

        self.train_x = put(train_x, torch.uint8)
        self.mask_x = put(mask_x, torch.bool)
        self.train_y = put(train_y, torch.uint8)
        self.bg_imgs = put(bg_imgs, torch.uint8)
        self.noof_obj_pixels = put(noof_obj_pixels, torch.int64)
        self.occlusion_masks = None if occlusion_masks is None else put(occlusion_masks, torch.bool)
        self.augmenter = build_augmenter(cfg.code)

    def nbytes(self) -> int:
        arrays = (self.train_x, self.mask_x, self.train_y, self.bg_imgs, self.noof_obj_pixels, self.occlusion_masks)
        return sum(a.numel() * a.element_size() for a in arrays if a is not None)

    # ------------------------------------------------------------- draws
    def _choice(self, gen, n: int, b: int) -> torch.Tensor:
        """b indices into n: without replacement, or with it when n < b."""
        if n < b:
            return torch.randint(0, n, (b,), generator=gen, device=self.device)
        return torch.randperm(n, generator=gen, device=self.device)[:b]

    def _stratified(self, gen, b: int) -> torch.Tensor:
        """b // n_objects indices into each object's pool, in object order:
        without replacement (the first of a random order of the pool: the
        sort of one uniform key a row), or with it when the pool is
        smaller; as rows of the whole pool."""
        n_o = self.n_objects
        if b % n_o:
            raise ValueError(f"a batch of {b} does not divide by the {n_o} objects of a multi-path pool")
        per, rows = b // n_o, self.train_x.shape[0] // n_o
        if rows < per:
            idcs = torch.randint(0, rows, (n_o, per), generator=gen, device=self.device)
        else:
            keys = torch.rand((n_o, rows), generator=gen, device=self.device)
            idcs = torch.argsort(keys, dim=1, stable=True)[:, :per]
        return (idcs + rows * torch.arange(n_o, device=self.device)[:, None]).reshape(b)

    def draw_batch(self, gen: torch.Generator, batch_size: int) -> Dict:
        """Every random number of one batch, as tensors on the device."""
        cfg, dev, b = self.cfg, self.device, batch_size
        n = self.train_x.shape[0]
        h, w, c = self.train_x.shape[1:]
        idcs = self._choice(gen, n, b) if self.n_objects == 1 else self._stratified(gen, b)
        draws: Dict = {"idcs": idcs, "bg_idcs": self._choice(gen, self.bg_imgs.shape[0], b)}
        r = OCCLUSION_RETRIES
        if cfg.realistic_occlusion and self.occlusion_masks is not None:
            sign = 2.0 * torch.randint(0, 2, (r, b, 2), generator=gen, device=dev) - 1.0
            mag = MIN_TRANS + (MAX_TRANS - MIN_TRANS) * torch.rand((r, b, 2), generator=gen, device=dev)
            draws["rocc"] = {
                "pick": torch.randint(0, self.occlusion_masks.shape[0], (r, b), generator=gen, device=dev),
                "ty": (sign[..., 0] * mag[..., 0] * h).to(torch.int32),
                "tx": (sign[..., 1] * mag[..., 1] * w).to(torch.int32),
            }
        if cfg.square_occlusion:
            cells = (r, b, _cells(h, SQUARE_SIZE_PERCENT), _cells(w, SQUARE_SIZE_PERCENT))
            draws["socc"] = {
                "keep": _bernoulli(gen, 1.0 - SQUARE_P, cells, dev),
                "apply": _bernoulli(gen, SQUARE_SOMETIMES, (r, b), dev),
            }
        if cfg.neighbor_clutter:
            lo_s, hi_s = cfg.neighbor_clutter_shift

            def rand_shift(size):
                mag = torch.randint(int(lo_s * size), int(hi_s * size), (b,), generator=gen, device=dev)
                return mag * (2 * torch.randint(0, 2, (b,), generator=gen, device=dev) - 1)

            draws["clutter"] = [
                {
                    "nb_idcs": torch.randint(0, n, (b,), generator=gen, device=dev),
                    "dy": rand_shift(h),
                    "dx": rand_shift(w),
                    "apply": _bernoulli(gen, cfg.neighbor_clutter, (b,), dev),
                }
                for _ in range(max(1, int(cfg.neighbor_clutter_count)))
            ]
        draws["aug"] = self.augmenter.draw(gen, (b, h, w, c), dev)
        return draws

    # ------------------------------------------------------------- compose
    def composite(self, draws: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x, y) before augmentation: the object composited over its
        (cluttered) background through its (occluded) mask, and the target,
        both uint8 (B, H, W, C)."""
        cfg = self.cfg
        idcs = draws["idcs"]
        x = self.train_x[idcs]
        masks = self.mask_x[idcs]
        if "rocc" in draws:
            masks = realistic_occlusion(masks, self.occlusion_masks, draws["rocc"], cfg.realistic_occlusion)
        if "socc" in draws:
            masks = square_occlusion(masks, self.noof_obj_pixels[idcs], draws["socc"], cfg.square_occlusion)
        bg = self.bg_imgs[draws["bg_idcs"]]
        for paste in draws.get("clutter", ()):
            # another sample's render, shifted toward the crop's edge, pasted
            # into the background: neighbouring instances in padded crops
            nb_x = shift2d(self.train_x[paste["nb_idcs"]], paste["dy"], paste["dx"], wrap=True)
            nb_obj = shift2d(~self.mask_x[paste["nb_idcs"]], paste["dy"], paste["dx"], wrap=True)
            cluttered = torch.where(nb_obj[..., None], nb_x, bg)
            bg = torch.where(paste["apply"][:, None, None, None], cluttered, bg)
        return torch.where(masks[..., None], bg, x), self.train_y[idcs]

    def compose_batch(self, draws: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(batch_x, batch_y) f32 in [0, 1] from `draw_batch`'s draws."""
        x, y = self.composite(draws)
        x = self.augmenter.apply(draws["aug"], x.float())
        return x / 255.0, y.float() / 255.0

    def sample_batch(
        self, gen: torch.Generator, batch_size: int, shard: Tuple[int, int] = (0, 1)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(batch_x, batch_y) of `batch_size` from `gen`. With `shard`
        (index, count), the draws are the whole batch's, then slice `index`
        of `count` is composed: a rank composes its rows of the batch one
        process draws (drawing per rank would not: `randperm(n)[:b]`
        depends on b)."""
        draws = self.draw_batch(gen, batch_size)
        index, count = shard
        if count > 1:
            draws = slice_draws(draws, *shard_range(batch_size, index, count))
        return self.compose_batch(draws)
