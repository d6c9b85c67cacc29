"""The operations and bytes of one multi-path training step, from its
shapes: the shared encoder at the whole batch, and the bank of n_o
decoders, each at its object's batch / n_o rows, with `_flops.step_ops`'s
counts (2 per multiply-add; each operand read once, each result written
once). Every decoder reads its own weights and writes its own weight
gradient, so the bank's bytes are n_o times one decoder's at b_o rows: at
8 rows an object its weight-gradient convolutions are bound by memory.
The bank's entries keep the names `decoder.*`; at n_o = 1 the list is
`_flops.step_ops`'s."""

from __future__ import annotations

from typing import Dict, List

from . import _flops


def step_ops(h: int, w: int, c: int, filters: List[int], k_enc: int, k_dec: int, latent: int, n_objects: int,
             batch: int, precision: str) -> List[Dict]:
    """Every convolution and matmul of one step, forward and backward."""
    shapes = (h, w, c, filters, k_enc, k_dec, latent)
    encoder = [o for o in _flops.step_ops(*shapes, batch, precision) if not o["name"].startswith("decoder.")]
    bank = [dict(o, flops=o["flops"] * n_objects, bytes=o["bytes"] * n_objects)
            for o in _flops.step_ops(*shapes, batch // n_objects, precision) if o["name"].startswith("decoder.")]
    return encoder + bank


def bank_ops(ops: List[Dict]) -> List[Dict]:
    """The decoder bank's entries of `step_ops`."""
    return [o for o in ops if o["name"].startswith("decoder.")]
