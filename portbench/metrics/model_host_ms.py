"""Host ms per step of the model step: the self time of `aae.train.forward`
with the spans inside it (`aae.ops.*`, `aae.loss.*`) counted in, less the
thread's waits on the device; plus, in each `aae.train.backward`, the
issuing thread's and the autograd engine's threads' operators less their
waits."""

from ._program import backward_us, host_ms, per_step, spans


def read(r):
    forward = host_ms(r, "train.forward")
    if forward is None:
        return None

    def backward(t, steps):
        engine = t.backward_threads()
        return sum(backward_us(t, b, engine) for b in spans(t, "train.backward")) / 1e3

    return forward + per_step(r, backward)
