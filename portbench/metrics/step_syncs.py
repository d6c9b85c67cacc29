"""Host calls per step that wait for the device inside `aae.train.step`,
on any thread: synchronizes of every kind and plain `cudaMemcpy`; polling
(`cudaEventQuery`) does not count."""

from ._program import bounds, is_sync, per_step, runtime_in


def read(r):
    return per_step(r, lambda t, steps: sum(runtime_in(t, *bounds(s), is_sync) for s in steps))
