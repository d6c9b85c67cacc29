"""Host ms per step in `aae.train.sample_batch` (the batch's draws and
composition), less the thread's waits on the device."""

from ._program import host_ms


def read(r):
    return host_ms(r, "train.sample_batch")
