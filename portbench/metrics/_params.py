"""The parameters of one AAE from its shapes: every leaf gets a gradient,
which a multi-rank step all-reduces. Parameters and their gradients are
float32 under either precision (PRECISION bfloat16 casts in the forward)."""

from __future__ import annotations

from typing import List

from ._flops import DTYPE_BYTES


def param_count(h: int, w: int, c: int, filters: List[int], k_enc: int, k_dec: int, latent: int) -> int:
    """Weights and biases of the encoder's stride-2 KxK convolutions, the
    latent and decoder dense layers, and the decoder's KxK convolutions and
    head (each 2x step keeps the published KxK kernel)."""
    n, cin = 0, c
    for f in filters:
        n += f * cin * k_enc * k_enc + f
        cin = f
    flat = -(-h // 2 ** len(filters)) * -(-w // 2 ** len(filters)) * filters[-1]
    n += 2 * latent * flat + latent + flat
    rev = list(reversed(filters)) + [c]
    for a, b in zip(rev[:-1], rev[1:]):
        n += b * a * k_dec * k_dec + b
    return n


def grad_bytes(h: int, w: int, c: int, filters: List[int], k_enc: int, k_dec: int, latent: int) -> int:
    """Bytes of one step's gradients, in float32."""
    return DTYPE_BYTES["float32"] * param_count(h, w, c, filters, k_enc, k_dec, latent)
