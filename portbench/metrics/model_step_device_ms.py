"""Device ms per step of the model step: the operations launched inside
`AAE.forward` (encoder, decoder, the bootstrapped loss) and by the autograd
engine (their backward), less the communication kernels (the gradients'
all-reduce that a multi-rank step launches from the backward, which
`comm_device_ms` reads)."""

from ._trace import is_comm


def read(r):
    if r.trace is None or not r.trace.ops or not r.steps_traced:
        return None
    us = sum(o.dur for o in r.trace.ops if o.layer in ("forward", "backward") and not is_comm(o))
    return us / 1e3 / r.steps_traced
