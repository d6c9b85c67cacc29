"""Device ms per step of the operations launched inside the optimizer's
`step` (`training/state.OptaxOptimizer`)."""


def read(r):
    if r.trace is None or not r.trace.ops or not r.steps_traced:
        return None
    return r.trace.layer_us("optimizer") / 1e3 / r.steps_traced
