"""The decoder bank's share of its roofline: the least time the card could
take over one step's bank, its dense layers and phase-kernel convolutions
forward and backward (operations and bytes from the shapes,
`_flops_mp.step_ops`, against the per-dtype peaks of `_peaks`), over the
bank's device time a step (`decoder_bank_device_ms`, every kernel the
bank launches)."""

from . import decoder_bank_device_ms
from ._flops_mp import bank_ops
from ._peaks import least_seconds


def read(r):
    ms = decoder_bank_device_ms.read(r)
    ops = bank_ops(r.step_ops)
    if not ms or not ops:
        return None
    return 100.0 * least_seconds(ops) * 1e3 / ms
