"""Device ms per step of the operations launched inside
`DeviceDataset.sample_batch` (draws, composition, augmentation)."""


def read(r):
    if r.trace is None or not r.trace.ops or not r.steps_traced:
        return None
    return r.trace.layer_us("sample_batch") / 1e3 / r.steps_traced
