"""Device ms per step of the model step: the operations launched inside
`AAE.forward` (encoder, decoder, the bootstrapped loss) and by the autograd
engine (their backward)."""


def read(r):
    if r.trace is None or not r.trace.ops or not r.steps_traced:
        return None
    return r.trace.layer_us("forward", "backward") / 1e3 / r.steps_traced
