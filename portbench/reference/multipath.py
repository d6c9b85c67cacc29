"""The Multi-Path Encoder's training step in plain PyTorch (Sundermeyer et
al., "Multi-path Learning for Object Pose Estimation Across Domains",
CVPR 2020, arXiv:1908.00151; its code is the `multipath` branch of
github.com/DLR-RM/AugmentedAutoencoder): one encoder E shared by n_o
objects and one decoder D_o for each. A batch holds b_o rows of every
object, in object order; row i of object o is reconstructed by
D_o(E(x_i)) and scored by the bootstrapped L2 against its own target, and
the gradients of every decoder flow into the one encoder. Optax's Adam.

It imports nothing of the program and no module of the JAX package, and
reuses `model.py`'s plain layers: `model.forward` (Flax's SAME padding,
the published upsample-then-conv decoder), `model.bootstrapped_l2`,
`model.Adam` and `model.make_weights`. A Python loop over the objects
decodes each object's rows with its own decoder, in float32 with TF32
off, or through `lowp` (the control).

Departures from the paper, and what it leaves open:
  * the encoder runs on each object's rows in that object's turn of the
    loop, since `model.forward` holds encoder and decoder in one; without
    BatchNorm a row's code depends on that row alone, so this is E on the
    whole batch, up to the order in which its gradient sums the rows;
  * the loss is the mean over all rows of each row's bootstrapped L2
    (ratio as configured); with equal rows an object, the mean of the
    objects' losses (assumed: how the branch weighs the objects is not
    confirmed here);
  * the batch is stratified: b_o = batch / n_o rows of every object in
    every step, drawn without replacement from that object's pool
    (assumed);
  * the encoder and each decoder have the AAE template's layers and
    widths (assumed: the paper reuses the AAE's architecture);
  * weights are Flax's initializers (lecun normal kernels, zero biases),
    one template AAE's draw for the encoder and object 0's decoder and
    one for each further object's decoder (`make_weights`), not the
    TensorFlow initializers of the published code.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from . import augment, model

Params = Dict[str, torch.Tensor]


def make_weights(arch: model.Arch, n_objects: int, seed: int, device) -> Params:
    """The run's initial parameters under the program's names: the encoder
    and object 0's decoder as `model.make_weights` draws a template AAE
    from `seed`, object o's decoder as it draws one from
    `model.derive_seed(seed, o)`; each decoder leaf stacked on a leading
    object axis."""
    parts = [model.make_weights(arch, seed if o == 0 else model.derive_seed(seed, o), device)
             for o in range(n_objects)]
    out = {k: v for k, v in parts[0].items() if k.startswith("encoder.")}
    for k in parts[0]:
        if k.startswith("decoder."):
            out[k] = torch.stack([p[k] for p in parts])
    return out


def draw_batch(gen, n_objects: int, rows: int, n_bg: int, batch: int, chain: augment.Op, shape, device) -> dict:
    """The step's draws from `gen`, in order: batch / n_objects indices into
    each object's pool of `rows` renders (the first of a random order of
    the pool, by the sort of one uniform key a render; with replacement
    where the pool is smaller), as rows of the pools stacked in object
    order; the backgrounds; then the augmentation chain's draws, row by row
    as the one-object batch draws them."""
    per = batch // n_objects
    if rows < per:
        idcs = torch.randint(0, rows, (n_objects, per), generator=gen, device=device)
    else:
        keys = torch.rand((n_objects, rows), generator=gen, device=device)
        idcs = torch.argsort(keys, dim=1, stable=True)[:, :per]
    idcs = (idcs + rows * torch.arange(n_objects, device=device)[:, None]).reshape(batch)
    if n_bg < batch:
        bg_idcs = torch.randint(0, n_bg, (batch,), generator=gen, device=device)
    else:
        bg_idcs = torch.randperm(n_bg, generator=gen, device=device)[:batch]
    return {"idcs": idcs, "bg_idcs": bg_idcs, "aug": augment.draw_chain(chain, gen, (batch,) + tuple(shape), device)}


def forward(arch: model.Arch, p: Params, x: torch.Tensor, n_objects: int,
            lowp: Optional[Callable] = None) -> torch.Tensor:
    """x (n_o * b_o, H, W, C) in object order -> the reconstruction, each
    object's rows through the encoder and that object's decoder."""
    b = x.shape[0] // n_objects
    encoder = {k: v for k, v in p.items() if k.startswith("encoder.")}
    out = []
    for o in range(n_objects):
        p_o = {**encoder, **{k: v[o] for k, v in p.items() if k.startswith("decoder.")}}
        out.append(model.forward(arch, p_o, x[o * b:(o + 1) * b], lowp))
    return torch.cat(out)


def reference_record(arch: model.Arch, n_objects: int, chain: augment.Op, pool: dict, weights: Params, seed: int,
                     batch: int, steps: int, lowp: Optional[Callable] = None) -> dict:
    """The reference's `steps` steps from `weights` (not changed), in float32
    with TF32 off, or through `lowp` (the control): the record that
    `compare.compare` reads, {"losses", "grad" (the first step's), "p0",
    "pN"}."""
    device = next(iter(weights.values())).device
    rows, n_bg = pool["train_x"].shape[0] // n_objects, pool["bg"].shape[0]
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    opt = model.Adam(params, arch.lr)
    losses: List[float] = []
    grad1 = None
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(steps):
            gen = torch.Generator(device=device).manual_seed(model.derive_seed(seed, i))
            draws = draw_batch(gen, n_objects, rows, n_bg, batch, chain, (arch.h, arch.w, arch.c), device)
            x, y = augment.compose_batch(pool, draws, chain, torch.float32)
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            loss = model.bootstrapped_l2(forward(arch, leaves, x, n_objects, lowp), y, arch.bootstrap)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            params = {k: v.detach() for k, v in leaves.items()}
            opt.step(params, grads)
            losses.append(loss.detach().item())
            if grad1 is None:
                grad1 = grads
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm
    return {"losses": losses, "grad": grad1, "p0": weights, "pN": params}


def per_object(tree: Params, n_objects: int) -> Params:
    """`tree` with each decoder leaf split into its objects' leaves,
    `<name>[<o>]`, so that the comparison holds every object's decoder to
    its own (a decoder fed another object's rows shows in its own leaf)."""
    out = {}
    for k, v in tree.items():
        if k.startswith("decoder."):
            out.update({f"{k}[{o}]": v[o] for o in range(n_objects)})
        else:
            out[k] = v
    return out
