"""Host ms per step of the training loop's own work: the self time of each
`aae.train.step` (its interval less the batch, forward, backward and
optimizer spans inside it, less the thread's waits on the device in what
is left). Covers the step's seeding, the log block, a flush's host side
and the loop."""

from ._program import STEP_PARTS, host_ms


def read(r):
    return host_ms(r, "train.step", minus=STEP_PARTS)
