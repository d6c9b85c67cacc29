"""The convolutions' share of their roofline: the least time the card
could take over one step's convolutions (their operations and bytes from
the shapes, `_flops.step_ops`, against `_peaks`) over the device time of
the operations launched directly by a convolution operator, per traced
step."""

from ._peaks import least_seconds


def is_conv(op) -> bool:
    return op.op is not None and "convolution" in op.op


def read(r):
    if r.trace is None or not r.trace.ops or not r.steps_traced or not r.step_ops:
        return None
    conv_us = sum(o.dur for o in r.trace.ops if is_conv(o)) / r.steps_traced
    if conv_us <= 0:
        return None
    least = least_seconds([o for o in r.step_ops if o["kind"] == "conv"])
    return 100.0 * least * 1e6 / conv_us
