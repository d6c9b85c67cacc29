"""Ms per step in which a communication kernel runs on the device and no
other kernel does: the part of the all-reduce that DDP's overlap with the
backward does not hide. The union of the communication kernels' intervals
less its intersection with the union of all other device operations'.
None where the trace holds no communication kernel."""

from ._trace import intersection, is_comm, total, union


def read(r):
    if r.trace is None or not r.steps_traced:
        return None
    comm = union((o.ts, o.ts + o.dur) for o in r.trace.ops if is_comm(o))
    if not comm:
        return None
    other = union((o.ts, o.ts + o.dur) for o in r.trace.ops if not is_comm(o))
    return (total(comm) - total(intersection(comm, other))) / 1e3 / r.steps_traced
