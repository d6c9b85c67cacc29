"""The Augmented Autoencoder's training step in plain PyTorch: the
published model (Sundermeyer et al., `auto_pose/ae/encoder.py`,
`decoder.py`, `ae.py`) with Flax's SAME padding and initializers, the
bootstrapped L2 loss, and optax's Adam.

It imports nothing of the program. The decoder upsamples by nearest
neighbour and then convolves (the published form), so it checks the
program's fused phase convolutions rather than repeating them. Matmuls
and convolutions run in float32 with TF32 off, or, for the control,
with every operand rounded to a lower precision (`lowp`).

`make_weights` makes the initial parameters from the run's seed, which
the harness hands to the program and to the reference alike. Parameter
names are the program's, so the two can be set side by side.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
#: optax's Adam
B1, B2, EPS = 0.9, 0.999, 1e-8
#: the init seed's tag, outside the range of step numbers
INIT_TAG = 2**31 - 1


def derive_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for (seed, tag), mixed by numpy's SeedSequence."""
    a, b = np.random.SeedSequence([int(seed), int(tag)]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


class Arch:
    """The sizes of one AAE, read from the configuration's keys."""

    def __init__(self, cfg: Dict[str, Dict[str, str]]):
        num = lambda s, k: eval(cfg[s][k], {"__builtins__": {}})  # noqa: S307 (repo data)
        self.h, self.w, self.c = (int(num("Dataset", k)) for k in ("H", "W", "C"))
        self.filters = [int(f) for f in num("Network", "NUM_FILTER")]
        self.strides = [int(s) for s in num("Network", "STRIDES")]
        self.k_enc = int(num("Network", "KERNEL_SIZE_ENCODER"))
        self.k_dec = int(num("Network", "KERNEL_SIZE_DECODER"))
        self.latent = int(num("Network", "LATENT_SPACE_SIZE"))
        self.bootstrap = int(num("Network", "BOOTSTRAP_RATIO"))
        self.lr = float(num("Training", "LEARNING_RATE"))
        for key, want in (("LOSS", "L2"), ("OPTIMIZER", "Adam"), ("BATCH_NORMALIZATION", "False"),
                          ("AUXILIARY_MASK", "False"), ("VARIATIONAL", "0"), ("NORM_REGULARIZE", "0")):
            if cfg["Network" if key != "OPTIMIZER" else "Training"][key].strip() != want:
                raise NotImplementedError(f"the reference has {key} {want} only")
        if any(s != 2 for s in self.strides):
            raise NotImplementedError("the reference has stride-2 layers only")
        self.bottom = (self.h // 2 ** len(self.strides), self.w // 2 ** len(self.strides))

    def leaves(self) -> List[Tuple[str, Tuple[int, ...], int]]:
        """(name, shape, fan_in) of every parameter, in the model's order."""
        out = []
        cin = self.c
        for i, f in enumerate(self.filters):
            out += [(f"encoder.convs.{i}.weight", (f, cin, self.k_enc, self.k_enc), cin * self.k_enc ** 2),
                    (f"encoder.convs.{i}.bias", (f,), 0)]
            cin = f
        flat = self.bottom[0] * self.bottom[1] * self.filters[-1]
        out += [("encoder.latent.weight", (self.latent, flat), flat), ("encoder.latent.bias", (self.latent,), 0),
                ("decoder.dense.weight", (flat, self.latent), self.latent), ("decoder.dense.bias", (flat,), 0)]
        rev = list(reversed(self.filters))
        for i, (a, b) in enumerate(zip(rev[:-1], rev[1:])):
            out += [(f"decoder.convs.{i}.weight", (b, a, self.k_dec, self.k_dec), a * self.k_dec ** 2),
                    (f"decoder.convs.{i}.bias", (b,), 0)]
        out += [("decoder.reconstruction.weight", (self.c, rev[-1], self.k_dec, self.k_dec),
                 rev[-1] * self.k_dec ** 2),
                ("decoder.reconstruction.bias", (self.c,), 0)]
        return out


def make_weights(arch: Arch, seed: int, device) -> Params:
    """Flax's initial parameters for the run `seed`, made on `device` in one
    draw: a unit normal truncated to +-2 for every kernel, each scaled to
    variance 1 / fan_in (lecun normal), and zero biases."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, INIT_TAG))
    leaves = arch.leaves()
    flat = torch.empty(sum(math.prod(s) for _, s, fan in leaves if fan), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    params, at = {}, 0
    for name, shape, fan_in in leaves:
        if fan_in:
            n = math.prod(shape)
            params[name] = flat[at:at + n].view(shape) * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)
            at += n
        else:
            params[name] = torch.zeros(shape, device=device)
    return params


def _same(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def forward(arch: Arch, p: Params, x: torch.Tensor, lowp: Optional[Callable] = None) -> torch.Tensor:
    """x (B, H, W, C) in [0, 1] -> the reconstruction (B, H, W, C)."""
    q = lowp or (lambda t: t)
    h = x.permute(0, 3, 1, 2)
    for i, s in enumerate(arch.strides):
        ph, pw = _same(h.shape[2], arch.k_enc, s), _same(h.shape[3], arch.k_enc, s)
        h = F.pad(h, (pw[0], pw[1], ph[0], ph[1]))
        h = F.relu(F.conv2d(q(h), q(p[f"encoder.convs.{i}.weight"]), p[f"encoder.convs.{i}.bias"], stride=s))
    flat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC order, as Flax flattens
    z = F.linear(q(flat), q(p["encoder.latent.weight"]), p["encoder.latent.bias"])
    d = F.relu(F.linear(q(z), q(p["decoder.dense.weight"]), p["decoder.dense.bias"]))
    d = d.reshape(-1, arch.bottom[0], arch.bottom[1], arch.filters[-1]).permute(0, 3, 1, 2)
    pad = arch.k_dec // 2
    for i in range(len(arch.filters) - 1):
        d = F.interpolate(d, scale_factor=2, mode="nearest")
        d = F.relu(F.conv2d(q(d), q(p[f"decoder.convs.{i}.weight"]), p[f"decoder.convs.{i}.bias"], padding=pad))
    d = F.interpolate(d, scale_factor=2, mode="nearest")
    d = F.conv2d(q(d), q(p["decoder.reconstruction.weight"]), p["decoder.reconstruction.bias"], padding=pad)
    return torch.sigmoid(d).permute(0, 2, 3, 1)


def bootstrapped_l2(recon: torch.Tensor, target: torch.Tensor, ratio: int) -> torch.Tensor:
    """Mean of each sample's top numel // ratio squared errors."""
    b = recon.shape[0]
    err = (recon.reshape(b, -1) - target.reshape(b, -1)) ** 2
    if ratio <= 1:
        return err.mean()
    k = err.shape[1] // ratio
    with torch.no_grad():
        kth = torch.kthvalue(err, err.shape[1] - k + 1, dim=1, keepdim=True).values
    return (err * (err >= kth).to(err.dtype)).sum() / (b * k)


class Adam:
    """optax.adam(lr) over a dict of float32 tensors."""

    def __init__(self, params: Params, lr: float):
        self.lr = lr
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        self.count += 1
        # optax's bias corrections: 1 - decay**count in float32
        one, n = np.float32(1.0), np.float32(self.count)
        bc1, bc2 = float(one - np.float32(B1) ** n), float(one - np.float32(B2) ** n)
        for k, g in grads.items():
            self.mu[k].mul_(B1).add_((1.0 - B1) * g)
            self.nu[k].mul_(B2).add_((1.0 - B2) * g * g)
            params[k].sub_(self.lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS))
