"""The share of the traced window in which no operation runs on the
device: one minus the union of the device operations' intervals (not
their summed time, which counts concurrent operations twice) over the
window."""


def read(r):
    if r.trace is None or not r.trace.ops or r.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_us() / r.trace.window_us)
