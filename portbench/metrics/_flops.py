"""The operations and bytes of one AAE training step, from its shapes.

Counted as `torch.utils.flop_counter` counts them (2 per multiply-add;
a convolution's backward as its data gradient, where the input needs one,
plus its weight gradient), for the step as the port computes it: the
encoder's stride-2 KxK convolutions, the latent and decoder dense layers,
and each of the decoder's 2x steps and its head as one convolution of
4 x Cout channels over the map before upsampling, on the common window of
the four parity phases (3x3 for K = 5). Bytes count each operand read
once and each result written once.

Under PRECISION bfloat16 the convolutions and the decoder's dense layer
run in bf16, the latent and reconstruction heads in f32.
"""

from __future__ import annotations

from typing import Dict, List

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def _phase_window(k: int) -> int:
    """Side of the common window of the four parity phases of a KxK kernel."""
    p = (k - 1) // 2
    return 2 * ((p + 1) // 2) + 1


def _op(kind, name, dtype, flops, operands, result, grad_input=True) -> List[Dict]:
    """Forward, weight-gradient and (with `grad_input`) data-gradient entries.
    `operands` = (input elements, weight elements), `result` = output elements."""
    n_in, n_w = operands
    b = DTYPE_BYTES[dtype]
    out = [{"kind": kind, "name": name + ".fwd", "dtype": dtype, "flops": flops, "bytes": b * (n_in + n_w + result)},
           {"kind": kind, "name": name + ".wgrad", "dtype": dtype, "flops": flops,
            "bytes": b * (n_in + result + n_w)}]
    if grad_input:
        out.append({"kind": kind, "name": name + ".dgrad", "dtype": dtype, "flops": flops,
                    "bytes": b * (result + n_w + n_in)})
    return out


def step_ops(h: int, w: int, c: int, filters: List[int], k_enc: int, k_dec: int, latent: int, batch: int,
             precision: str) -> List[Dict]:
    """Every convolution and matmul of one step, forward and backward."""
    low = precision
    ops: List[Dict] = []
    hh, ww, cin = h, w, c
    for i, f in enumerate(filters):
        ho, wo = -(-hh // 2), -(-ww // 2)
        flops = 2 * batch * f * ho * wo * cin * k_enc * k_enc
        ops += _op("conv", f"encoder.convs.{i}", low, flops,
                   (batch * hh * ww * cin, f * cin * k_enc * k_enc), batch * ho * wo * f, grad_input=i > 0)
        hh, ww, cin = ho, wo, f
    flat = hh * ww * cin
    ops += _op("matmul", "encoder.latent", "float32", 2 * batch * flat * latent,
               (batch * flat, flat * latent), batch * latent)
    ops += _op("matmul", "decoder.dense", low, 2 * batch * latent * flat,
               (batch * latent, latent * flat), batch * flat)
    rev = list(reversed(filters)) + [c]
    n = _phase_window(k_dec)
    for i, (a, b) in enumerate(zip(rev[:-1], rev[1:])):
        head = i == len(rev) - 2
        name = "decoder.reconstruction" if head else f"decoder.convs.{i}"
        flops = 2 * batch * 4 * b * hh * ww * a * n * n
        ops += _op("conv", name, "float32" if head else low, flops,
                   (batch * hh * ww * a, 4 * b * a * n * n), batch * hh * ww * 4 * b)
        hh, ww = 2 * hh, 2 * ww
    return ops
