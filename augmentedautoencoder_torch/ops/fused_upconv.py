"""Fused 2x nearest upsample + KxK SAME conv, without the upsampled map
(port of augmentedautoencoder_tpu/ops/fused_upconv.py).

Nearest upsampling by 2 means up[a, b] = x[a // 2, b // 2], so each output
parity phase (p, q) of the high-resolution conv is a small conv over the
original map whose kernel sums the taps of `w` that land on the same source
pixel:

    out[2i + p, 2j + q] = sum_{u, v} K_pq[u, v] . x[i + u, j + v]

Tap d of a K-wide kernel reads source offset (p + d - (K - 1) // 2) // 2
(`phase_offsets`). The phase kernels sum their taps in the JAX loop's order
(d outer, e inner), so each f32 entry is the same chain of additions.

The four phases are one `F.conv2d` with 4 * Cout output channels, then
`F.pixel_shuffle(2)` interleaves them. All phases share one window of
source offsets: for odd K the union of the two parities' windows is
symmetric, [-(P + 1) // 2, (P + 1) // 2] with P = (K - 1) // 2. For K = 5
both parities read -1..1, so every tap is real. For K = 3 parity 0 reads
-1..0 and parity 1 reads 0..1: each phase is embedded in the common 3x3
window with zero taps, which compute the same function (the JAX package
convolves each phase over its own window; only cuDNN's summation order can
differ). One cuDNN call a layer instead of four.

Both forms compute in the dtype of `x` and `w` (the decoder casts its f32
weight to the compute dtype first, as the JAX `_UpConv` does). In bf16 the
phase kernels are sums of bf16 taps, each addition rounded, in the JAX
loop's order, and the bias is added to the rounded bf16 output, as the JAX
module adds it after the interleave (`conv2d`; the same sums before it).
The phase kernels' gradient sums each tap's four phase entries in f32,
rounded once to bf16 in bf16.

The convolutions are cuDNN's (`F.conv2d`): the JAX module is XLA code, not
a Pallas kernel. `upsample2x_conv_plain` is the unfused form (upsample,
then the KxK conv), kept for the tests and the card's check.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
    """`F.conv2d` as a Flax `nn.Conv` computes it in x's dtype: in bf16 the
    convolution's output is rounded to bf16 and the bias added to it after,
    in bf16; in f32 and f64 the bias stays fused into cuDNN's call."""
    if b is None or x.dtype != torch.bfloat16:
        return F.conv2d(x, w, b, **kw)
    return F.conv2d(x, w, None, **kw) + b.view(-1, 1, 1)


def phase_offsets(p: int, K: int) -> List[int]:
    """Source-row offset of each of the K taps for output parity `p`."""
    P = (K - 1) // 2
    return [(p + d - P) // 2 for d in range(K)]


def _window(K: int) -> Tuple[int, int]:
    offs = phase_offsets(0, K) + phase_offsets(1, K)
    lo, hi = min(offs), max(offs)
    assert lo == -hi, (K, lo, hi)
    return lo, hi


@lru_cache(maxsize=None)
def _tap_slots(K: int) -> np.ndarray:
    """(S, 2, 2, n, n) indices into w's K * K flattened taps (K * K names a
    zero tap): slot s of phase (p, q) at window entry (u, v) is the s-th tap,
    in d-outer, e-inner order, that lands there."""
    lo, hi = _window(K)
    n = hi - lo + 1
    taps = {}
    for p in (0, 1):
        ro = phase_offsets(p, K)
        for q in (0, 1):
            co = phase_offsets(q, K)
            for d in range(K):
                for e in range(K):
                    taps.setdefault((p, q, ro[d] - lo, co[e] - lo), []).append(d * K + e)
    slots = np.full((max(map(len, taps.values())), 2, 2, n, n), K * K, np.int64)
    for (p, q, u, v), ts in taps.items():
        slots[: len(ts), p, q, u, v] = ts
    return slots


@lru_cache(maxsize=None)
def _tap_map(K: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_tap_slots(K)` on `device`, and its inverse (4, K * K): for phase
    p * 2 + q, the flat (u * n + v) window entry that tap d * K + e lands
    in (every tap lands in exactly one entry of each phase). Built once per
    (K, device), so a call copies nothing to the device and waits for
    nothing."""
    slots = _tap_slots(K)
    n = slots.shape[-1]
    inv = np.full((4, K * K), -1, np.int64)
    for s, p, q, u, v in zip(*np.nonzero(slots < K * K)):
        tap = slots[s, p, q, u, v]
        assert inv[p * 2 + q, tap] < 0, (K, p, q, tap)
        inv[p * 2 + q, tap] = u * n + v
    assert (inv >= 0).all(), K
    return torch.from_numpy(slots).to(device), torch.from_numpy(inv).to(device)


class _PhaseKernels(torch.autograd.Function):
    """`phase_kernels` as one autograd node. The backward gathers each
    tap's four phase entries through the inverse map and adds them in phase
    order in at least f32, rounding once to w's dtype: autograd would make
    the forward's gathers a scatter (a sort and an accumulating index_put).
    Leading axes of `w` before (Cout, Cin, K, K), such as a decoder bank's
    object axis, are folded into Cout: each (cout, cin) entry's sums are
    its own, so a stack is one gather and one chain of additions."""

    @staticmethod
    def forward(ctx, w):
        *lead, cin, K, _ = w.shape
        cout = math.prod(lead)
        slots, inv = _tap_map(K, w.device)
        ctx.inv, ctx.w_shape = inv, w.shape
        S, window = slots.shape[0], tuple(slots.shape[1:])
        # (S, Cout, Cin, 4 n n): each slot's taps contiguous, so each addition is a dense one
        flat = F.pad(w.reshape(cout, cin, K * K), (0, 1)).expand(S, cout, cin, K * K + 1)
        taps = flat.gather(3, slots.view(S, 1, 1, -1).expand(S, cout, cin, -1))
        kern = w.new_zeros((cout, cin) + window)
        for s in range(S):
            kern = kern + taps[s].view((cout, cin) + window)
        return kern.view(tuple(lead) + (cin,) + window)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        *lead, cin, K, _ = ctx.w_shape
        cout = math.prod(lead)
        # (4, Cout, Cin, K K): each phase's entries of every tap, contiguous
        phases = grad.reshape(cout, cin, 4, -1).permute(2, 0, 1, 3)
        g = phases.gather(3, ctx.inv.view(4, 1, 1, K * K).expand(4, cout, cin, K * K))
        acc = g[0].to(torch.promote_types(grad.dtype, torch.float32))
        for i in range(1, 4):
            acc = acc + g[i]
        return acc.to(grad.dtype).view(ctx.w_shape)


def phase_kernels(w: torch.Tensor) -> torch.Tensor:
    """(..., Cout, Cin, 2, 2, n, n): the four phases' kernels of OIHW `w`
    (K odd; leading axes, such as a decoder bank's objects, kept)
    on the common n x n window, each entry the left-to-right sum of its taps
    in the JAX loop's order (a zero tap adds 0.0), in w's dtype, each
    addition rounded to it. Differentiable in `w` (`_PhaseKernels`: the
    gradient of each tap is its four phase entries summed in at least f32,
    rounded once). Recorded as the span `aae.ops.phase_kernels`, which holds
    the gather and the additions; the tap map is on the device after a
    (K, device)'s first call, so the span neither copies nor waits."""
    from ..training.profiler import span  # the training package imports the decoder, which imports this

    with span("ops.phase_kernels"):
        return _PhaseKernels.apply(w)


def phase_kernel(w: torch.Tensor, p: int, q: int):
    """Phase (p, q)'s OIHW kernel on its own window, and its (pad_lo, pad_hi)
    per spatial axis, as the JAX `phase_kernel` returns them (HWIO there)."""
    K = w.shape[2]
    lo, _ = _window(K)
    ro, co = phase_offsets(p, K), phase_offsets(q, K)
    rlo, rhi, clo, chi = min(ro), max(ro), min(co), max(co)
    kern = phase_kernels(w)[:, :, p, q, rlo - lo:rhi - lo + 1, clo - lo:chi - lo + 1]
    return kern, (-rlo, rhi), (-clo, chi)


def upsample2x_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv2d(nearest_upsample_2x(x), w, stride 1, SAME) (+ b) without the
    upsampled map: x (B, Cin, H, W), w (Cout, Cin, K, K) with K odd, b (Cout,);
    returns (B, Cout, 2H, 2W). A stack w (G, Cout, Cin, K, K), b (G, Cout)
    convolves G groups of channels, each by its own kernel, in one grouped
    convolution: x (B, G * Cin, H, W) -> (B, G * Cout, 2H, 2W), group g's
    channels g * C to (g + 1) * C - 1 on both sides (a decoder bank)."""
    groups = w.shape[0] if w.dim() == 5 else 1
    cout, cin, K = w.shape[-4], w.shape[-3], w.shape[-1]
    lo, _ = _window(K)
    # output channel (g * Cout + c) * 4 + p * 2 + q is phase (p, q) of group g's channel c: pixel_shuffle's order
    kern = phase_kernels(w).movedim(-5, -3).reshape(groups * 4 * cout, cin, 1 - 2 * lo, 1 - 2 * lo)
    bias = None if b is None else b.reshape(-1).repeat_interleave(4)
    return F.pixel_shuffle(conv2d(x, kern, bias, padding=-lo, groups=groups), 2)


def upsample2x_conv_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The unfused form: nearest 2x upsample, then the KxK SAME conv."""
    return conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w, b, padding="same")
