"""On-device domain randomization (port of augmentedautoencoder_tpu/data/augment.py):
the cfg's augmentation chain over a batch (B, H, W, C) of f32 images in
[0, 255] on the device.

Every op is split into a DRAW (its random parameters as tensors, from a
`torch.Generator` on the images' device) and an APPLY (deterministic, given
those parameters), so that the JAX package's draws can be fed to the apply
and compared. `build_augmenter(spec)` returns an `Augmenter` whose
`draw(gen, shape, device)` returns the nested parameters of the whole chain
and whose `apply(params, imgs)` runs it; calling it does both.

The semantics are the JAX package's (imgaug's defaults for the subset the
reference uses, train_template.cfg:26-37): values are clipped to [0, 255]
after every value op (uint8 saturation); `Sometimes` and `OneOf` compute
their children on the whole batch and select per image; integer `Add`
ranges draw discrete uniforms; `per_channel=q` draws, per image with
probability q, one value per channel instead of one shared value.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import augment_spec as S

Params = Any  # nested dicts / lists of tensors


# ------------------------------------------------------------------ draws

def _uniform(gen, shape, lo, hi, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _bernoulli(gen, p, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) < p


def _per_image_param(gen, b, c, lo, hi, per_channel, device, discrete=False) -> torch.Tensor:
    """A (B, 1, 1, C) parameter: one value per image, or with probability
    `per_channel` one per channel (imgaug's per_channel)."""
    if discrete:
        shared = torch.randint(int(lo), int(hi) + 1, (b, 1, 1, 1), generator=gen, device=device).float()
        per_ch = torch.randint(int(lo), int(hi) + 1, (b, 1, 1, c), generator=gen, device=device).float()
    else:
        shared = _uniform(gen, (b, 1, 1, 1), lo, hi, device)
        per_ch = _uniform(gen, (b, 1, 1, c), lo, hi, device)
    if per_channel <= 0.0:
        return shared.expand(b, 1, 1, c)
    if per_channel >= 1.0:
        return per_ch
    use_pc = _bernoulli(gen, per_channel, (b, 1, 1, 1), device)
    return torch.where(use_pc, per_ch, shared)


def _keep_mask(gen, keep_p, per_channel, shape, c, device) -> torch.Tensor:
    """(B, h, w, 1 or C) keep mask: shared over channels, or per channel for
    a `per_channel` share of the images (all of them at per_channel >= 1)."""
    b, h, w = shape
    shared = _bernoulli(gen, keep_p, (b, h, w, 1), device)
    if per_channel <= 0.0:
        return shared
    per_ch = _bernoulli(gen, keep_p, (b, h, w, c), device)
    if per_channel >= 1.0:
        return per_ch
    return torch.where(_bernoulli(gen, per_channel, (b, 1, 1, 1), device), per_ch, shared)


# ------------------------------------------------------------------ shared math

def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img (H, W, C) at float coords (any equal shapes);
    zeros outside (the JAX package's `_bilinear_sample`)."""
    h, w, _ = img.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0i, x0i = y0.long(), x0.long()

    def fetch(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        return img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)] * inside[..., None]

    return (
        fetch(y0i, x0i) * (1 - wy) * (1 - wx)
        + fetch(y0i, x0i + 1) * (1 - wy) * wx
        + fetch(y0i + 1, x0i) * wy * (1 - wx)
        + fetch(y0i + 1, x0i + 1) * wy * wx
    )


def interp_matrix(coords: torch.Tensor, n: int) -> torch.Tensor:
    """(B, m) float source coords -> (B, m, n) bilinear interpolation
    matrix; out-of-range coords give zero rows (the JAX package's
    `_interp_matrix`)."""
    lo = torch.floor(coords)
    frac = coords - lo
    loi = lo.long()
    grid = torch.arange(n, device=coords.device)
    onehot_lo = (loi[..., None] == grid).float()
    onehot_hi = (loi[..., None] + 1 == grid).float()
    inside = ((coords >= 0) & (coords <= n - 1))[..., None]
    m = onehot_lo * (1.0 - frac)[..., None] + onehot_hi * frac[..., None]
    return m * inside


def _nearest_rows(n_out: int, n_in: int, device) -> torch.Tensor:
    return torch.arange(n_out, device=device) * n_in // n_out


def _cells(size: int, size_percent: float) -> int:
    return max(1, int(round(size * size_percent)))


def upsample_cells(keep: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour upsample of a (B, gh, gw, ...) cell mask to (B, h, w, ...)."""
    gh, gw = keep.shape[1:3]
    return keep[:, _nearest_rows(h, gh, keep.device)][:, :, _nearest_rows(w, gw, keep.device)]


# ------------------------------------------------------------------ ops: (draw, apply)

def _affine_draw(spec: S.Affine, gen, shape, device):
    lo, hi = S.as_range(spec.scale)
    return {"scales": _uniform(gen, (shape[0],), lo, hi, device)}


def _affine_apply(spec: S.Affine, p, imgs):
    # center scaling is separable: per-image (H, H) and (W, W) bilinear
    # interpolation matrices, two batched matmuls
    b, h, w, _ = imgs.shape
    scales = p["scales"]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = (torch.arange(h, dtype=torch.float32, device=imgs.device)[None, :] - cy) / scales[:, None] + cy
    xs = (torch.arange(w, dtype=torch.float32, device=imgs.device)[None, :] - cx) / scales[:, None] + cx
    tmp = torch.einsum("bhj,bjwc->bhwc", interp_matrix(ys, h), imgs)
    return torch.einsum("bwk,bhkc->bhwc", interp_matrix(xs, w), tmp)


def _coarse_dropout_draw(spec: S.CoarseDropout, gen, shape, device):
    b, h, w, c = shape
    cells = (b, _cells(h, spec.size_percent), _cells(w, spec.size_percent))
    return {"keep": _keep_mask(gen, 1.0 - spec.p, spec.per_channel, cells, c, device)}


def _coarse_dropout_apply(spec, p, imgs):
    return imgs * upsample_cells(p["keep"], imgs.shape[1], imgs.shape[2])


def _dropout_draw(spec: S.Dropout, gen, shape, device):
    b, h, w, c = shape
    return {"keep": _keep_mask(gen, 1.0 - spec.p, spec.per_channel, (b, h, w), c, device)}


def _dropout_apply(spec, p, imgs):
    return imgs * p["keep"]


def _blur_radius(spec: S.GaussianBlur) -> Tuple[float, float, int]:
    lo, hi = S.as_range(spec.sigma)
    return lo, hi, max(1, int(math.ceil(2.6 * hi)))


def _gaussian_blur_draw(spec: S.GaussianBlur, gen, shape, device):
    lo, hi, _ = _blur_radius(spec)
    if hi < 1e-3 or lo == hi:
        return {}  # no blur, or the scalar sigma fixed when the cfg was parsed
    return {"sigmas": _uniform(gen, (shape[0],), lo, hi, device)}


def _gaussian_blur_apply(spec: S.GaussianBlur, p, imgs):
    lo, hi, radius = _blur_radius(spec)
    if hi < 1e-3:
        return imgs
    b, h, w, c = imgs.shape
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=imgs.device)
    x = F.pad(imgs.permute(0, 3, 1, 2), (radius, radius, radius, radius), mode="replicate")
    if lo == hi:
        # the reference chain's case: one depthwise separable conv
        k1d = torch.exp(-0.5 * (offs / hi) ** 2)
        k1d = k1d / k1d.sum()
        y = F.conv2d(x, k1d.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
        y = F.conv2d(y, k1d.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
        return y.permute(0, 2, 3, 1)
    # per-image sigma: separable blur as two batched matmuls against banded
    # Toeplitz matrices (the JAX package's banded blur)
    sigmas = p["sigmas"]
    kern = torch.exp(-0.5 * (offs[None, :] / torch.clamp(sigmas[:, None], min=1e-6)) ** 2)
    ident = (offs == 0).float()[None, :]
    kern = torch.where((sigmas < 1e-3)[:, None], ident, kern)
    kern = kern / kern.sum(dim=1, keepdim=True)  # (B, 2r+1)

    def banded(n):
        rows = torch.arange(n, device=imgs.device)[:, None]
        cols = torch.arange(n + 2 * radius, device=imgs.device)[None, :]
        offset = cols - rows
        band = (offset >= 0) & (offset <= 2 * radius)
        return torch.where(band[None], kern[:, offset.clamp(0, 2 * radius)], torch.zeros((), device=imgs.device))

    xp = x.permute(0, 2, 3, 1)  # (B, h+2r, w+2r, C)
    tmp = torch.einsum("bhj,bjwc->bhwc", banded(h), xp)
    return torch.einsum("bwk,bhkc->bhwc", banded(w), tmp)


def _is_discrete(lo, hi) -> bool:
    return float(lo).is_integer() and float(hi).is_integer()


def _add_draw(spec: S.Add, gen, shape, device):
    b, _, _, c = shape
    lo, hi = S.as_range(spec.value)
    return {"value": _per_image_param(gen, b, c, lo, hi, spec.per_channel, device, _is_discrete(lo, hi))}


def _add_apply(spec, p, imgs):
    return torch.clamp(imgs + p["value"], 0.0, 255.0)


def _noise_draw(spec: S.AdditiveGaussianNoise, gen, shape, device):
    b, h, w, c = shape
    lo, hi = S.as_range(spec.scale)
    scale = _uniform(gen, (b, 1, 1, 1), lo, hi, device)
    nc = c if spec.per_channel >= 1.0 else 1
    noise = torch.randn((b, h, w, nc), generator=gen, device=device) * scale + spec.loc
    if 0.0 < spec.per_channel < 1.0:
        noise_pc = torch.randn((b, h, w, c), generator=gen, device=device) * scale + spec.loc
        use_pc = _bernoulli(gen, spec.per_channel, (b, 1, 1, 1), device)
        noise = torch.where(use_pc, noise_pc, noise.expand(b, h, w, c))
    return {"noise": noise}


def _noise_apply(spec, p, imgs):
    return torch.clamp(imgs + p["noise"], 0.0, 255.0)


def _multiply_draw(spec: S.Multiply, gen, shape, device):
    lo, hi = S.as_range(spec.mul)
    return {"mul": _per_image_param(gen, shape[0], shape[3], lo, hi, spec.per_channel, device)}


def _multiply_apply(spec, p, imgs):
    return torch.clamp(imgs * p["mul"], 0.0, 255.0)


def _invert_draw(spec: S.Invert, gen, shape, device):
    b, c = shape[0], shape[3]
    inv = _bernoulli(gen, spec.p, (b, 1, 1, 1), device)
    if spec.per_channel > 0.0:
        inv_pc = _bernoulli(gen, spec.p, (b, 1, 1, c), device)
        inv = torch.where(_bernoulli(gen, spec.per_channel, (b, 1, 1, 1), device), inv_pc, inv)
    return {"invert": inv}


def _invert_apply(spec, p, imgs):
    return torch.where(p["invert"], 255.0 - imgs, imgs)


def _contrast_draw(spec: S.ContrastNormalization, gen, shape, device):
    lo, hi = S.as_range(spec.alpha)
    return {"alpha": _per_image_param(gen, shape[0], shape[3], lo, hi, spec.per_channel, device)}


def _contrast_apply(spec, p, imgs):
    return torch.clamp((imgs - 128.0) * p["alpha"] + 128.0, 0.0, 255.0)


def _flip_draw(spec, gen, shape, device):
    return {"flip": _bernoulli(gen, spec.p, (shape[0], 1, 1, 1), device)}


def _fliplr_apply(spec, p, imgs):
    return torch.where(p["flip"], imgs.flip(2), imgs)


def _flipud_apply(spec, p, imgs):
    return torch.where(p["flip"], imgs.flip(1), imgs)


def _grayscale_draw(spec: S.Grayscale, gen, shape, device):
    lo, hi = S.as_range(spec.alpha)
    return {"alpha": _uniform(gen, (shape[0], 1, 1, 1), lo, hi, device)}


def _grayscale_apply(spec, p, imgs):
    alpha = p["alpha"]
    if imgs.shape[3] == 3:
        # images are BGR (cv2 convention throughout the pipeline)
        gray = (0.114 * imgs[..., 0] + 0.587 * imgs[..., 1] + 0.299 * imgs[..., 2])[..., None]
    else:
        gray = imgs.mean(dim=-1, keepdim=True)
    return imgs * (1 - alpha) + gray * alpha


#: the 12 ops: spec type -> (draw, apply)
OP_TABLE: Dict[type, Tuple[Callable, Callable]] = {
    S.Affine: (_affine_draw, _affine_apply),
    S.CoarseDropout: (_coarse_dropout_draw, _coarse_dropout_apply),
    S.Dropout: (_dropout_draw, _dropout_apply),
    S.GaussianBlur: (_gaussian_blur_draw, _gaussian_blur_apply),
    S.Add: (_add_draw, _add_apply),
    S.AdditiveGaussianNoise: (_noise_draw, _noise_apply),
    S.Multiply: (_multiply_draw, _multiply_apply),
    S.Invert: (_invert_draw, _invert_apply),
    S.ContrastNormalization: (_contrast_draw, _contrast_apply),
    S.Fliplr: (_flip_draw, _fliplr_apply),
    S.Flipud: (_flip_draw, _flipud_apply),
    S.Grayscale: (_grayscale_draw, _grayscale_apply),
}


# ------------------------------------------------------------------ the chain

class Augmenter:
    """A compiled AugSpec tree. `draw(gen, shape, device)` -> params;
    `apply(params, imgs)` -> imgs; `aug(gen, imgs)` does both.

    Parameters by node: an op, its dict of tensors; Sequential, a list of
    its children's; Sequential(random_order=True), {"perm": list of child
    indices, "steps": the chosen child's params per step}; Sometimes,
    {"apply": (B, 1, 1, 1) bool, "child": ...}; OneOf, {"choice":
    (B, 1, 1, 1) int, "children": [...]}; Noop / None, {}."""

    def __init__(self, spec: Optional[S.AugSpec]):
        self.spec = spec
        self.children: List[Augmenter] = []
        if isinstance(spec, S.Sequential) or isinstance(spec, S.OneOf):
            self.children = [Augmenter(c) for c in spec.children]
        elif isinstance(spec, S.Sometimes):
            self.children = [Augmenter(spec.child)]
        elif spec is not None and not isinstance(spec, S.Noop) and type(spec) not in OP_TABLE:
            raise NotImplementedError(f"augmenter not implemented: {type(spec).__name__}")

    def draw(self, gen: torch.Generator, shape, device) -> Params:
        spec = self.spec
        if spec is None or isinstance(spec, S.Noop):
            return {}
        if isinstance(spec, S.Sequential):
            if spec.random_order:
                # a fresh order of the children per batch; step j runs the
                # child perm[j] with draws of its own
                n = len(self.children)
                perm = torch.randperm(n, generator=gen, device=device).tolist()
                return {"perm": perm, "steps": [self.children[i].draw(gen, shape, device) for i in perm]}
            return [c.draw(gen, shape, device) for c in self.children]
        if isinstance(spec, S.Sometimes):
            return {
                "apply": _bernoulli(gen, float(spec.p), (shape[0], 1, 1, 1), device),
                "child": self.children[0].draw(gen, shape, device),
            }
        if isinstance(spec, S.OneOf):
            return {
                "choice": torch.randint(0, len(self.children), (shape[0], 1, 1, 1), generator=gen, device=device),
                "children": [c.draw(gen, shape, device) for c in self.children],
            }
        return OP_TABLE[type(spec)][0](spec, gen, tuple(shape), device)

    def apply(self, params: Params, imgs: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        if spec is None or isinstance(spec, S.Noop):
            return imgs
        if isinstance(spec, S.Sequential):
            if spec.random_order:
                for i, p in zip(params["perm"], params["steps"]):
                    imgs = self.children[i].apply(p, imgs)
                return imgs
            for c, p in zip(self.children, params):
                imgs = c.apply(p, imgs)
            return imgs
        if isinstance(spec, S.Sometimes):
            return torch.where(params["apply"], self.children[0].apply(params["child"], imgs), imgs)
        if isinstance(spec, S.OneOf):
            out = imgs
            for i, (c, p) in enumerate(zip(self.children, params["children"])):
                out = torch.where(params["choice"] == i, c.apply(p, imgs), out)
            return out
        return OP_TABLE[type(spec)][1](spec, params, imgs)

    def __call__(self, gen: torch.Generator, imgs: torch.Tensor) -> torch.Tensor:
        return self.apply(self.draw(gen, imgs.shape, imgs.device), imgs)


def build_augmenter(spec: Optional[S.AugSpec]) -> Augmenter:
    """Compile an AugSpec tree (the cfg's CODE) into an Augmenter."""
    return Augmenter(spec)
