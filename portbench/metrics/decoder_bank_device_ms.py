"""Device ms per step of the decoder bank: the kernels, copies and sets
launched inside the program's span `aae.ops.decoder_bank` (the bank's
forward) and inside the autograd engine's nodes that its operators made
(its backward), as `model_step_device_ms` counts the backward; the union
of their intervals, so that operations that overlap count once
(`_bank.BankTrace`)."""


def read(r):
    us = getattr(r.trace, "bank_us", None)
    if us is None or not r.steps_traced:
        return None
    return us / 1e3 / r.steps_traced
