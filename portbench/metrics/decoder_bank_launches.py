"""Launches per step of the decoder bank (kernel launches, asynchronous
copies and sets): inside the program's span `aae.ops.decoder_bank` and
inside the autograd engine's nodes of its backward (`_bank.BankTrace`)."""


def read(r):
    n = getattr(r.trace, "bank_launches", None)
    if n is None or not r.steps_traced:
        return None
    return n / r.steps_traced
