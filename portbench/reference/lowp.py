"""The control's arithmetic: the reference with every operand of its
convolutions and matmuls rounded to the precision one step below the
configuration's, forward and backward.

  float32  -> TF32: the mantissa rounded to 10 bits, to nearest even, as
              the tensor cores take float32 operands when TF32 is on
  bfloat16 -> fp8, as fp8 training's hybrid format takes it: operands
              in e4m3, gradients in e5m2, each tensor scaled so that its
              largest value is the format's largest, rounded, and scaled
              back

The rounding is an autograd function whose backward rounds the incoming
gradient (TF32, or e5m2), so the data- and weight-gradient convolutions
see rounded operands too.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties to even)."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32).to(t.dtype)


def _scaled(fmt: torch.dtype):
    largest = torch.finfo(fmt).max

    def round_(t: torch.Tensor) -> torch.Tensor:
        scale = largest / t.detach().abs().max().float().clamp(min=1e-30)
        return ((t.float() * scale).to(fmt).float() / scale).to(t.dtype)

    return round_


round_e4m3, round_e5m2 = _scaled(torch.float8_e4m3fn), _scaled(torch.float8_e5m2)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, fn, grad_fn):
        ctx.grad_fn = grad_fn
        return fn(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.grad_fn(g), None, None


#: name -> (rounding of the operands, rounding of the gradients)
ROUNDINGS = {"tf32": (round_tf32, round_tf32), "fp8": (round_e4m3, round_e5m2)}
#: the precision a configuration states -> its control's rounding
CONTROL_OF = {"float32": "tf32", "bfloat16": "fp8"}


def operand_rounding(name: Optional[str]) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The `lowp` function of the reference's forward for `name`, or None."""
    if name is None:
        return None
    fn, grad_fn = ROUNDINGS[name]
    return lambda t: _Round.apply(t, fn, grad_fn)
