"""Host ms per step in `aae.train.optimizer` (the update), less the
thread's waits on the device."""

from ._program import host_ms


def read(r):
    return host_ms(r, "train.optimizer")
