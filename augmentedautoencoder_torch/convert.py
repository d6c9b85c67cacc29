"""Carry the JAX package's weights and optimizer state into the port.

`params_from_jax` takes the Flax parameter tree as nested dicts of numpy
arrays (so it imports no jax) and returns the port's `AAE` state dict:

  * conv kernels HWIO -> OIHW (encoder `Conv_i` -> `encoder.convs.i`;
    decoder `Conv_i` -> `decoder.convs.i`, `reconstruction`, `mask_head`);
  * dense kernels (in, out) -> (out, in) (`latent`, `latent_sigma`, the
    decoder's `Dense_0` -> `decoder.dense`); both sides flatten and reshape
    NHWC, so no row permutation is needed;
  * BatchNorm `scale`/`bias` -> `weight`/`bias` and the batch stats
    `mean`/`var` -> `running_mean`/`running_var` (epsilon 1e-5 on both
    sides); the decoder's `BatchNorm_0` follows its Dense layer
    (`decoder.bn_dense`), `BatchNorm_j` its conv j-1 (`decoder.bns.{j-1}`).

By default it carries the encoder only, the state dict serving loads;
`decoder=True` carries the decoder too, for training.

`opt_state_from_jax` turns the flat optax leaves that the JAX package's
`save_train_state` stores (`jax.tree.leaves(opt_state)`) into the port's
`OptaxOptimizer` state, each slot laid out as its parameter.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

_INDEXED = re.compile(r"^(Conv|BatchNorm|Dense)_(\d+)$")

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(a) -> torch.Tensor:
    return _t(a).permute(3, 2, 0, 1).contiguous()


def _dense(a) -> torch.Tensor:
    return _t(a).T.contiguous()


def _port_name(scope: str, group: str, leaf: str) -> Tuple[str, Callable]:
    """(port state-dict key, layout transform) of one Flax leaf."""
    m = _INDEXED.match(group)
    kind, idx = (m.group(1), int(m.group(2))) if m else (group, None)
    if kind == "BatchNorm":
        if scope == "decoder":
            module = "decoder.bn_dense" if idx == 0 else f"decoder.bns.{idx - 1}"
        else:
            module = f"encoder.bns.{idx}"
        return f"{module}.{_BN_LEAVES[leaf]}", _t
    if leaf == "bias":
        fn = _t
    elif kind in ("Conv", "reconstruction", "mask_head"):
        fn = _conv
    elif kind in ("Dense", "latent", "latent_sigma"):
        fn = _dense
    else:
        raise KeyError(f"unexpected {scope} parameter {group}/{leaf}")
    if kind == "Conv":
        return f"{scope}.convs.{idx}.{'weight' if leaf == 'kernel' else 'bias'}", fn
    module = {"Dense": "dense"}.get(kind, kind)
    if module not in ("latent", "latent_sigma", "dense", "reconstruction", "mask_head"):
        raise KeyError(f"unexpected {scope} parameter group {group!r}")
    return f"{scope}.{module}.{'weight' if leaf == 'kernel' else 'bias'}", fn


def _scoped(tree: Optional[Mapping], decoder: bool) -> Dict[str, Mapping]:
    """{"encoder": ..., ["decoder": ...]} of an AAE tree, or of a bare
    Encoder tree (treated as the encoder)."""
    if tree is None:
        return {}
    if "encoder" not in tree and "decoder" not in tree:
        return {"encoder": tree}
    return {s: tree[s] for s in ("encoder", "decoder") if s in tree and (s == "encoder" or decoder)}


def params_from_jax(
    params: Mapping, batch_stats: Optional[Mapping] = None, decoder: bool = False
) -> Dict[str, torch.Tensor]:
    """Flax AAE (or Encoder) params [+ batch_stats] -> port AAE state dict;
    the encoder's alone unless `decoder`."""
    out: Dict[str, torch.Tensor] = {}
    stats = _scoped(batch_stats, decoder)
    for scope, groups in _scoped(params, decoder).items():
        for group, leaves in groups.items():
            for leaf, value in leaves.items():
                key, fn = _port_name(scope, group, leaf)
                out[key] = fn(value)
            if group.startswith("BatchNorm_"):
                for leaf, value in stats[scope][group].items():
                    key, fn = _port_name(scope, group, leaf)
                    out[key] = fn(value)
                prefix = key.rsplit(".", 1)[0]
                out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


def _flat_leaves(tree: Mapping, path=()) -> List[Tuple[Tuple[str, ...], object]]:
    """(path, leaf) pairs in jax.tree.leaves order: dict keys sorted at
    every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out.extend(_flat_leaves(v, path + (k,)))
        else:
            out.append((path + (k,), v))
    return out


#: optax's state leaves per optimizer, after the count where there is one
_OPT_SLOTS = {
    "adam": ("mu", "nu"),
    "sgd": (),
    "gradientdescent": (),
    "rmsprop": ("nu",),
    "adagrad": ("sum_of_squares",),
    "momentum": ("trace",),
}


def opt_state_from_jax(opt_leaves: Sequence, params: Mapping, optimizer: str) -> Dict:
    """`jax.tree.leaves(state.opt_state)` of the JAX package's optimizer
    (training/state.py `_OPTIMIZERS`) over the Flax AAE `params` -> the
    port's `OptaxOptimizer.state_dict()` for the full AAE (decoder
    included). Adam's leaves are [count, mu..., nu...]; rmsprop's,
    adagrad's and momentum's one slot; sgd has none."""
    name = optimizer.lower()
    if name not in _OPT_SLOTS:
        raise ValueError(f"unknown optimizer: {optimizer}")
    slots = _OPT_SLOTS[name]
    named = []
    for path, _ in _flat_leaves({s: t for s, t in _scoped(params, True).items()}):
        named.append(_port_name(path[0], path[1], path[2]))
    leaves = list(opt_leaves)
    count = torch.tensor(0, dtype=torch.int32)
    if name == "adam":
        count = torch.tensor(int(np.asarray(leaves.pop(0))), dtype=torch.int32)
    n = len(named)
    if len(leaves) != n * len(slots):
        raise ValueError(f"{len(leaves)} optimizer leaves for {n} parameters and slots {slots}")
    out = {}
    for j, slot in enumerate(slots):
        out[slot] = {key: fn(leaves[j * n + i]) for i, (key, fn) in enumerate(named)}
    return {"name": name, "count": count, "slots": out}
