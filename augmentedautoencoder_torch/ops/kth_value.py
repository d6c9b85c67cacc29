"""Per-row k-th largest value (port of augmentedautoencoder_tpu/ops/kth_value.py).

The JAX package finds the k-th largest of each row of the bootstrapped
loss's error matrix by a 31-step bisection on the f32 bit patterns,
bit-identical to `lax.top_k(err, k)[0][:, -1:]`. The k-th largest is an
element of the row, so `torch.kthvalue` (a selection, no sort) returns the
same f32 bits.
"""

from __future__ import annotations

import torch

_F32_MAX = torch.finfo(torch.float32).max


def kth_largest(err: torch.Tensor, k: int) -> torch.Tensor:
    """Exact per-row k-th largest of a NON-NEGATIVE f32 (B, N) matrix, as
    (B, 1). +inf entries count as the largest finite f32, as in the JAX
    package (its bisection clamps them)."""
    if not (0 < k <= err.shape[1]):
        raise ValueError(f"k={k} out of range for {tuple(err.shape)}")
    if err.dtype != torch.float32:
        raise TypeError(f"kth_largest requires float32 input, got {err.dtype}")
    err = torch.clamp(err, max=_F32_MAX)
    return torch.kthvalue(err, err.shape[1] - k + 1, dim=1, keepdim=True).values
