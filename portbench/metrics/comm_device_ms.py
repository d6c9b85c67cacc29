"""Device ms per step in communication kernels (NCCL's): the gradients'
all-reduce that DDP launches from the backward, bucket by bucket, and the
logged losses' all-reduce. A kernel's time includes its wait for the other
ranks to reach the same collective. None where the trace holds none."""

from ._trace import is_comm


def read(r):
    if r.trace is None or not r.steps_traced:
        return None
    us = sum(o.dur for o in r.trace.ops if is_comm(o))
    return us / 1e3 / r.steps_traced if us > 0 else None
