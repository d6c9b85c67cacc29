"""Typed augmentation specs — the parsed form of the cfg [Augmentation] CODE DSL.

The reference `eval()`s an imgaug pipeline out of the config string
(auto_pose/ae/dataset.py:380-390; default chain train_template.cfg:26-37).
Here the same DSL text parses into these plain dataclasses; the device-side
implementation lives in augmentedautoencoder_tpu.data.augment (jitted JAX).

imgaug semantic notes preserved:
  * `Sometimes(p, aug)` applies aug to each image independently with prob p.
  * `per_channel=q` means: with prob q sample the parameter per channel,
    otherwise one sample shared by all channels.
  * scalar-or-range params: a scalar is deterministic, a (lo, hi) tuple is
    sampled uniformly per image.
  * `GaussianBlur(1.2*np.random.rand())` evaluates the sigma ONCE at config
    parse (reference quirk, train_template.cfg:31) — the spec stores a scalar.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

Range = Union[float, Tuple[float, float]]


def as_range(v: Range) -> Tuple[float, float]:
    if isinstance(v, (tuple, list)):
        lo, hi = v
        return (float(lo), float(hi))
    return (float(v), float(v))


@dataclasses.dataclass(frozen=True)
class AugSpec:
    """Base class for augmentation specs."""


@dataclasses.dataclass(frozen=True)
class Sequential(AugSpec):
    children: List[AugSpec]
    random_order: bool = False

    def __init__(self, children=(), random_order=False):
        object.__setattr__(self, "children", list(children))
        object.__setattr__(self, "random_order", bool(random_order))


@dataclasses.dataclass(frozen=True)
class Sometimes(AugSpec):
    p: float
    child: AugSpec


@dataclasses.dataclass(frozen=True)
class OneOf(AugSpec):
    children: List[AugSpec]

    def __init__(self, children=()):
        object.__setattr__(self, "children", list(children))


@dataclasses.dataclass(frozen=True)
class Noop(AugSpec):
    pass


@dataclasses.dataclass(frozen=True)
class Affine(AugSpec):
    """Center scale only (the reference chain uses Affine(scale=(1.0,1.2)))."""

    scale: Range = 1.0

    def __init__(self, scale=1.0, **_ignored):
        object.__setattr__(self, "scale", scale)


@dataclasses.dataclass(frozen=True)
class CoarseDropout(AugSpec):
    """Drop coarse rectangular cells to zero.

    p: per-cell drop probability; size_percent: low-res mask cell scale.
    """

    p: float = 0.0
    size_percent: float = 0.05
    per_channel: float = 0.0

    def __init__(self, p=0.0, size_percent=0.05, per_channel=0.0, **_ignored):
        object.__setattr__(self, "p", float(p))
        object.__setattr__(self, "size_percent", float(size_percent))
        object.__setattr__(self, "per_channel", float(per_channel))


@dataclasses.dataclass(frozen=True)
class Dropout(AugSpec):
    p: float = 0.0
    per_channel: float = 0.0

    def __init__(self, p=0.0, per_channel=0.0, **_ignored):
        object.__setattr__(self, "p", float(p))
        object.__setattr__(self, "per_channel", float(per_channel))


@dataclasses.dataclass(frozen=True)
class GaussianBlur(AugSpec):
    sigma: Range = 0.0


@dataclasses.dataclass(frozen=True)
class Add(AugSpec):
    value: Range = 0.0
    per_channel: float = 0.0

    def __init__(self, value=0.0, per_channel=0.0, **_ignored):
        object.__setattr__(self, "value", value)
        object.__setattr__(self, "per_channel", float(per_channel))


@dataclasses.dataclass(frozen=True)
class AdditiveGaussianNoise(AugSpec):
    loc: float = 0.0
    scale: Range = 0.0
    per_channel: float = 0.0

    def __init__(self, loc=0.0, scale=0.0, per_channel=0.0, **_ignored):
        object.__setattr__(self, "loc", float(loc))
        object.__setattr__(self, "scale", scale)
        object.__setattr__(self, "per_channel", float(per_channel))


@dataclasses.dataclass(frozen=True)
class Multiply(AugSpec):
    mul: Range = 1.0
    per_channel: float = 0.0

    def __init__(self, mul=1.0, per_channel=0.0, **_ignored):
        object.__setattr__(self, "mul", mul)
        object.__setattr__(self, "per_channel", float(per_channel))


@dataclasses.dataclass(frozen=True)
class Invert(AugSpec):
    p: float = 0.0
    per_channel: float = 0.0

    def __init__(self, p=0.0, per_channel=0.0, **_ignored):
        object.__setattr__(self, "p", float(p))
        object.__setattr__(self, "per_channel", float(per_channel))


@dataclasses.dataclass(frozen=True)
class ContrastNormalization(AugSpec):
    """(v - 128) * alpha + 128, alpha sampled from range."""

    alpha: Range = 1.0
    per_channel: float = 0.0

    def __init__(self, alpha=1.0, per_channel=0.0, **_ignored):
        object.__setattr__(self, "alpha", alpha)
        object.__setattr__(self, "per_channel", float(per_channel))


@dataclasses.dataclass(frozen=True)
class Fliplr(AugSpec):
    p: float = 0.5


@dataclasses.dataclass(frozen=True)
class Flipud(AugSpec):
    p: float = 0.5


@dataclasses.dataclass(frozen=True)
class Grayscale(AugSpec):
    alpha: Range = 1.0


#: Constructors exposed to the cfg [Augmentation] CODE DSL.
DSL_CONSTRUCTORS = {
    "Sequential": Sequential,
    "Sometimes": Sometimes,
    "OneOf": OneOf,
    "Noop": Noop,
    "Affine": Affine,
    "CoarseDropout": CoarseDropout,
    "Dropout": Dropout,
    "GaussianBlur": GaussianBlur,
    "Add": Add,
    "AdditiveGaussianNoise": AdditiveGaussianNoise,
    "Multiply": Multiply,
    "Invert": Invert,
    "ContrastNormalization": ContrastNormalization,
    "Fliplr": Fliplr,
    "Flipud": Flipud,
    "Grayscale": Grayscale,
}
