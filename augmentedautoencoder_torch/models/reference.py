"""The AAE in f64 throughout: the reference that the bf16 and f32 steps are
held against, on the CPU in the tests and on the card in chip_smoke.py.

`float64_model(model)` is a copy of `model` whose parameters, statistics
and compute dtype are f64 (its heads run in f64 too, `head_dtype`).
Inside `float64_loss()` the bootstrapped loss takes f64 errors: the k-th
largest per row by `torch.kthvalue` in f64, the selection `kth_largest`
makes in f32 (which refuses f64, as the JAX package's does).
"""

from __future__ import annotations

import contextlib
import copy

import torch

from . import losses


def float64_model(model):
    """A copy of the AAE `model` computing in f64."""
    ref = copy.deepcopy(model).double()
    for part in (ref.encoder, ref.decoder):
        if part is not None:
            part.compute_dtype = torch.float64
    return ref


def _kth_largest_f64(err: torch.Tensor, k: int) -> torch.Tensor:
    return torch.kthvalue(err, err.shape[1] - k + 1, dim=1, keepdim=True).values


@contextlib.contextmanager
def float64_loss():
    """The bootstrapped loss on f64 errors inside the block."""
    kth, losses.kth_largest = losses.kth_largest, _kth_largest_f64
    try:
        yield
    finally:
        losses.kth_largest = kth
