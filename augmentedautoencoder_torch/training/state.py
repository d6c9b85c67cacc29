"""Train state (port of augmentedautoencoder_tpu/training/state.py): the
model's initial parameters (`init_parameters_`, used by
`factory.build_train_model`) and the optimizer, with optax's defaults and
formulas.

The cfg's `[Training] OPTIMIZER` names one of six optimizers, as the JAX
package's `_OPTIMIZERS` maps them to optax (reference ae_factory.py:79-95).
`torch.optim` with its defaults computes other functions (RMSprop's decay
is 0.99 and its eps lies outside the root, Adagrad's accumulator starts at
0), so `OptaxOptimizer` writes each update as optax does, in f32:

  adam      mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu;  count += 1
            u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
            b1 0.9, b2 0.999, eps 1e-8, eps_root 0
  rmsprop   nu = (1-d) g^2 + d nu;  u = g * rsqrt(nu + eps)    d 0.9, eps 1e-8
  adagrad   s = g^2 + s;  u = g * rsqrt(s + eps) where s > 0, else 0
            s starts at 0.1, eps 1e-7
  sgd / gradientdescent   u = g
  momentum  t = g + 0.9 t;  u = t
  and then  p = p - lr * u   (optax scales by -lr and adds)

`count` is an int32 that stops at its maximum, as optax's safe_increment.
The step the trainer reports is its own counter, as `TrainState.step`.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch
from torch import nn

from ..models.decoder import DecoderBank

# name -> (slots, their initial value); the update is in OptaxOptimizer.step
_OPTIMIZERS: Dict[str, Tuple[Tuple[str, ...], float]] = {
    "adam": (("mu", "nu"), 0.0),
    "sgd": ((), 0.0),
    "rmsprop": (("nu",), 0.0),
    "adagrad": (("sum_of_squares",), 0.1),
    "gradientdescent": ((), 0.0),
    "momentum": (("trace",), 0.0),
}
_INT32_MAX = 2**31 - 1


class OptaxOptimizer:
    """One of optax's six optimizers over named parameters.

    `state_dict()` is {"name", "count", "slots": {slot: {param: tensor}}};
    slots keep each parameter's shape and layout (so `convert.opt_state_from_jax`
    maps optax's leaves by the same permutations as the parameters)."""

    b1, b2, adam_eps = 0.9, 0.999, 1e-8
    rms_decay, rms_eps = 0.9, 1e-8
    adagrad_eps = 1e-7
    momentum = 0.9

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]], name: str, learning_rate: float):
        name = name.lower()
        if name not in _OPTIMIZERS:
            raise ValueError(f"unknown optimizer: {name}")
        self.name = name
        self.lr = float(learning_rate)
        self.params: Dict[str, nn.Parameter] = dict(named_params)
        slots, init = _OPTIMIZERS[name]
        self.slots: Dict[str, Dict[str, torch.Tensor]] = {
            s: {k: torch.full_like(p, init, memory_format=torch.preserve_format) for k, p in self.params.items()}
            for s in slots
        }
        device = next(iter(self.params.values())).device
        self.count = torch.zeros((), dtype=torch.int32, device=device)

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One optax update of every parameter that has a gradient."""
        if self.name == "adam":
            self.count = torch.where(self.count < _INT32_MAX, self.count + 1, self.count)
            c = self.count.float()
            # optax: 1 - decay**count in f32 (the f32 powers of the f32
            # decays), on the device: no host round trip
            bc1 = 1.0 - torch.pow(torch.full_like(c, self.b1), c)
            bc2 = 1.0 - torch.pow(torch.full_like(c, self.b2), c)
        for k, p in self.params.items():
            g = p.grad
            if g is None:
                continue
            if self.name == "adam":
                mu, nu = self.slots["mu"][k], self.slots["nu"][k]
                mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
                nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.adam_eps)
            elif self.name == "rmsprop":
                nu = self.slots["nu"][k]
                nu.copy_((1.0 - self.rms_decay) * (g * g) + self.rms_decay * nu)
                u = torch.rsqrt(nu + self.rms_eps) * g
            elif self.name == "adagrad":
                s = self.slots["sum_of_squares"][k]
                s.add_(g * g)
                u = torch.where(s > 0, torch.rsqrt(s + self.adagrad_eps), torch.zeros_like(s)) * g
            elif self.name == "momentum":
                t = self.slots["trace"][k]
                t.copy_(g + self.momentum * t)
                u = t
            else:
                u = g
            p.add_(-self.lr * u)

    def state_dict(self) -> Dict:
        return {
            "name": self.name,
            "count": self.count.detach().cpu(),
            "slots": {s: {k: v.detach().cpu() for k, v in d.items()} for s, d in self.slots.items()},
        }

    def load_state_dict(self, state: Dict) -> None:
        if state["name"] != self.name:
            raise ValueError(f"optimizer state of {state['name']!r} given to {self.name!r}")
        if set(state["slots"]) != set(self.slots):
            raise KeyError(f"optimizer slots {sorted(state['slots'])}, want {sorted(self.slots)}")
        for s, d in self.slots.items():
            if set(state["slots"][s]) != set(d):
                raise KeyError(f"optimizer slot {s!r}: parameters differ from the model's")
            for k, v in d.items():
                v.copy_(state["slots"][s][k])
        self.count = state["count"].to(device=self.count.device, dtype=torch.int32).clone()


def make_optimizer(model: nn.Module, cfg) -> OptaxOptimizer:
    """The cfg's optimizer over the model's parameters."""
    return OptaxOptimizer(model.named_parameters(), cfg.optimizer, cfg.learning_rate)


# ------------------------------------------------------------------ initial parameters

def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's default kernel init: a normal truncated to +-2 std, scaled to
    variance 1 / fan_in (variance_scaling(1, fan_in, truncated_normal))."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.mul_(std)


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter as Flax initializes the JAX model, from
    `generator` alone: conv and dense kernels lecun-normal over their fan
    in, biases 0, BatchNorm scale 1 and statistics (0, 1), and the VAE's
    `latent_sigma` kernel 0 (reference encoder.py:70-79). A decoder bank's
    objects are drawn each as one Flax decoder, at one decoder's fan in
    (not the stack's), from a stream of its own whose seed `generator`
    draws, in object order."""
    for name, mod in model.named_modules():
        if isinstance(mod, DecoderBank):
            seeds = torch.randint(0, 2**62, (mod.n_objects,), generator=generator).tolist()
            layers = [mod.dense, *mod.convs, mod.reconstruction]
            for o, seed in enumerate(seeds):
                stream = torch.Generator().manual_seed(seed)
                for layer in layers:
                    _lecun_normal_(layer.weight[o], layer.weight[o][0].numel(), stream)
            for layer in layers:
                layer.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            if name.endswith("latent_sigma"):
                mod.weight.zero_()
            else:
                _lecun_normal_(mod.weight, fan_in, generator)
            mod.bias.zero_()
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.reset_parameters()
    return model

