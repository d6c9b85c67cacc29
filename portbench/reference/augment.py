"""The training batch in plain PyTorch: every random number of one batch
drawn from the step's generator in the order the AAE recipe draws them,
the object composited over its background through its mask, and the
cfg's augmentation chain (imgaug's semantics for the ops the published
template uses).

It imports nothing of the program. The draws are made from the same
seeded generator on the same device, so they are the same numbers; the
composition and the augmentation are worked out again here, in the
reference's dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ------------------------------------------------------------------ the CODE string

@dataclass
class Op:
    kind: str
    args: tuple = ()
    kw: dict = field(default_factory=dict)


def _op(kind):
    return lambda *args, **kw: Op(kind, args, kw)


class _SeededNumpy:
    """`np` as the CODE string sees it: `np.random.rand()` is drawn once, at
    parse time, from a RandomState of the configuration's parse seed."""

    def __init__(self, seed: int):
        self.random = np.random.RandomState(seed)
        self.pi = np.pi


def parse_code(code: str, parse_seed: int) -> Op:
    """The augmentation chain of a cfg CODE string as a tree of `Op`."""
    names = {k: _op(k) for k in ("Sequential", "Sometimes", "Affine", "CoarseDropout", "GaussianBlur", "Add",
                                 "Invert", "Multiply", "ContrastNormalization")}
    names["np"] = _SeededNumpy(parse_seed)
    return eval(code, {"__builtins__": {}, "True": True, "False": False}, names)  # noqa: S307 (repo data)


def _range(v) -> Tuple[float, float]:
    if isinstance(v, (tuple, list)):
        return float(v[0]), float(v[1])
    return float(v), float(v)


def _kw(op: Op, name: str, pos: int, default):
    if name in op.kw:
        return op.kw[name]
    return op.args[pos] if len(op.args) > pos else default


# ------------------------------------------------------------------ draws

def _rand(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device)


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * _rand(gen, shape, device)


def _bern(gen, p, shape, device):
    return _rand(gen, shape, device) < p


def _per_image(gen, b, c, lo, hi, per_channel, device, discrete=False):
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
    return torch.where(_bern(gen, per_channel, (b, 1, 1, 1), device), per_ch, shared)


def _cells(size: int, size_percent: float) -> int:
    return max(1, int(round(size * size_percent)))


def draw_chain(op: Op, gen, shape, device) -> Any:
    """The chain's random numbers, in the order of its ops."""
    b, h, w, c = shape
    k = op.kind
    if k == "Sequential":
        if _kw(op, "random_order", 1, False):
            raise NotImplementedError("Sequential(random_order=True)")
        return [draw_chain(child, gen, shape, device) for child in _kw(op, "children", 0, [])]
    if k == "Sometimes":
        return {"apply": _bern(gen, float(op.args[0]), (b, 1, 1, 1), device),
                "child": draw_chain(op.args[1], gen, shape, device)}
    if k == "Affine":
        lo, hi = _range(_kw(op, "scale", 0, 1.0))
        return {"scales": _uniform(gen, (b,), lo, hi, device)}
    if k == "CoarseDropout":
        p, pc = float(_kw(op, "p", 0, 0.0)), float(_kw(op, "per_channel", 2, 0.0))
        if pc > 0.0:
            raise NotImplementedError("CoarseDropout(per_channel>0)")
        size = float(_kw(op, "size_percent", 1, 0.05))
        return {"keep": _bern(gen, 1.0 - p, (b, _cells(h, size), _cells(w, size), 1), device)}
    if k == "GaussianBlur":
        lo, hi = _range(_kw(op, "sigma", 0, 0.0))
        if lo != hi:
            raise NotImplementedError("GaussianBlur with a sigma range")
        return {}
    if k in ("Add", "Multiply", "ContrastNormalization"):
        lo, hi = _range(op.args[0] if op.args else next(iter(op.kw.values())))
        # imgaug's Add draws whole numbers from a range of whole numbers
        discrete = k == "Add" and lo.is_integer() and hi.is_integer()
        return {"v": _per_image(gen, b, c, lo, hi, float(_kw(op, "per_channel", 1, 0.0)), device, discrete)}
    if k == "Invert":
        p, pc = float(_kw(op, "p", 0, 0.0)), float(_kw(op, "per_channel", 1, 0.0))
        inv = _bern(gen, p, (b, 1, 1, 1), device)
        if pc > 0.0:
            inv_pc = _bern(gen, p, (b, 1, 1, c), device)
            inv = torch.where(_bern(gen, pc, (b, 1, 1, 1), device), inv_pc, inv)
        return {"invert": inv}
    raise NotImplementedError(f"augmenter {k}")


def draw_batch(gen, n_train: int, n_bg: int, batch: int, chain: Op, shape, device) -> dict:
    """Indices into the pool and the backgrounds, then the chain's draws."""
    def choice(n):
        if n < batch:
            return torch.randint(0, n, (batch,), generator=gen, device=device)
        return torch.randperm(n, generator=gen, device=device)[:batch]

    idcs = choice(n_train)
    bg_idcs = choice(n_bg)
    return {"idcs": idcs, "bg_idcs": bg_idcs, "aug": draw_chain(chain, gen, (batch,) + tuple(shape), device)}


# ------------------------------------------------------------------ apply

def _interp(coords: torch.Tensor, n: int) -> torch.Tensor:
    """(B, m) source coordinates -> (B, m, n) bilinear weights, a zero row
    where the coordinate falls outside [0, n - 1]."""
    lo = torch.floor(coords)
    frac = coords - lo
    grid = torch.arange(n, device=coords.device, dtype=coords.dtype)
    m = (lo[..., None] == grid) * (1.0 - frac)[..., None] + (lo[..., None] + 1 == grid) * frac[..., None]
    return m * ((coords >= 0) & (coords <= n - 1))[..., None]


def _nearest(n_out: int, n_in: int, device) -> torch.Tensor:
    return torch.arange(n_out, device=device) * n_in // n_out


def apply_chain(op: Op, p, imgs: torch.Tensor) -> torch.Tensor:
    k = op.kind
    b, h, w, c = imgs.shape
    if k == "Sequential":
        for child, cp in zip(_kw(op, "children", 0, []), p):
            imgs = apply_chain(child, cp, imgs)
        return imgs
    if k == "Sometimes":
        return torch.where(p["apply"], apply_chain(op.args[1], p["child"], imgs), imgs)
    if k == "Affine":
        # scale about the image centre, bilinear, zero outside
        s = p["scales"].to(imgs.dtype)
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        ys = (torch.arange(h, dtype=imgs.dtype, device=imgs.device)[None] - cy) / s[:, None] + cy
        xs = (torch.arange(w, dtype=imgs.dtype, device=imgs.device)[None] - cx) / s[:, None] + cx
        out = torch.einsum("bhj,bjwc->bhwc", _interp(ys, h), imgs)
        return torch.einsum("bwk,bhkc->bhwc", _interp(xs, w), out)
    if k == "CoarseDropout":
        keep = p["keep"]
        gh, gw = keep.shape[1:3]
        keep = keep[:, _nearest(h, gh, keep.device)][:, :, _nearest(w, gw, keep.device)]
        return imgs * keep
    if k == "GaussianBlur":
        sigma = _range(_kw(op, "sigma", 0, 0.0))[1]
        if sigma < 1e-3:
            return imgs
        r = max(1, int(math.ceil(2.6 * sigma)))
        offs = torch.arange(-r, r + 1, dtype=imgs.dtype, device=imgs.device)
        k1 = torch.exp(-0.5 * (offs / sigma) ** 2)
        k1 = k1 / k1.sum()
        x = F.pad(imgs.permute(0, 3, 1, 2), (r, r, r, r), mode="replicate")
        x = F.conv2d(x, k1.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
        x = F.conv2d(x, k1.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
        return x.permute(0, 2, 3, 1)
    if k == "Add":
        return torch.clamp(imgs + p["v"].to(imgs.dtype), 0.0, 255.0)
    if k == "Multiply":
        return torch.clamp(imgs * p["v"].to(imgs.dtype), 0.0, 255.0)
    if k == "ContrastNormalization":
        return torch.clamp((imgs - 128.0) * p["v"].to(imgs.dtype) + 128.0, 0.0, 255.0)
    if k == "Invert":
        return torch.where(p["invert"], 255.0 - imgs, imgs)
    raise NotImplementedError(f"augmenter {k}")


def compose_batch(pool: dict, draws: dict, chain: Op, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) in [0, 1]: the object over its background where the mask says
    background, then the chain on x; y is the clean target."""
    i = draws["idcs"]
    x = torch.where(pool["mask_x"][i][..., None], pool["bg"][draws["bg_idcs"]], pool["train_x"][i])
    x = apply_chain(chain, draws["aug"], x.to(dtype))
    return x / 255.0, pool["train_y"][i].to(dtype) / 255.0


def pool_on(device, train_x, mask_x, train_y, bg) -> dict:
    """The pool's arrays on `device` (uint8, the mask bool)."""
    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return {"train_x": put(train_x, torch.uint8), "mask_x": put(mask_x, torch.bool),
            "train_y": put(train_y, torch.uint8), "bg": put(bg, torch.uint8)}

