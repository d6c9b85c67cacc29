"""Carry the JAX package's encoder weights into the port.

`params_from_jax` takes the Flax parameter tree as nested dicts of numpy
arrays (so it imports no jax) and returns the port's `AAE` state dict:

  * conv kernels HWIO -> OIHW (`Conv_i` -> `encoder.convs.i`);
  * dense kernels (in, out) -> (out, in) (`latent`, `latent_sigma`); the
    encoder flattens NHWC, so no row permutation is needed;
  * BatchNorm `scale`/`bias` -> `weight`/`bias` and the batch stats
    `mean`/`var` -> `running_mean`/`running_var`. Flax's BatchNorm epsilon
    is 1e-5, the same as the port's BatchNorm2d.

The decoder's parameters are not carried: the port does not serve it yet.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_INDEXED = re.compile(r"^(Conv|BatchNorm)_(\d+)$")


def _encoder_tree(tree: Optional[Mapping]) -> Mapping:
    if tree is None:
        return {}
    return tree["encoder"] if "encoder" in tree else tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """Flax AAE (or Encoder) params [+ batch_stats] -> port AAE state dict."""
    enc = _encoder_tree(params)
    stats = _encoder_tree(batch_stats)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in enc.items():
        m = _INDEXED.match(name)
        if m and m.group(1) == "Conv":
            prefix = f"encoder.convs.{m.group(2)}"
            out[f"{prefix}.weight"] = _t(leaf["kernel"]).permute(3, 2, 0, 1).contiguous()
            out[f"{prefix}.bias"] = _t(leaf["bias"])
        elif m:
            prefix = f"encoder.bns.{m.group(2)}"
            out[f"{prefix}.weight"] = _t(leaf["scale"])
            out[f"{prefix}.bias"] = _t(leaf["bias"])
            out[f"{prefix}.running_mean"] = _t(stats[name]["mean"])
            out[f"{prefix}.running_var"] = _t(stats[name]["var"])
            out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif name in ("latent", "latent_sigma"):
            out[f"encoder.{name}.weight"] = _t(leaf["kernel"]).T.contiguous()
            out[f"encoder.{name}.bias"] = _t(leaf["bias"])
        else:
            raise KeyError(f"unexpected encoder parameter group {name!r}")
    return out
