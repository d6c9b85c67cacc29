"""The whole training step's share of the card's peak: the step's
operations (`_flops.step_ops`, forward and backward) times the steps of
the measured window, over the window's seconds, over the published peak
of the cell's precision (`_peaks.FLOPS`)."""

from ._peaks import FLOPS


def read(r):
    if not r.window_steps or r.window_s <= 0 or not r.step_ops:
        return None
    flops = sum(o["flops"] for o in r.step_ops)
    return 100.0 * flops * r.window_steps / r.window_s / FLOPS[r.precision]
