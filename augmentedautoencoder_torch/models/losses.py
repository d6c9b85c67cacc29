"""Loss functions (port of augmentedautoencoder_tpu/models/losses.py):
bootstrapped top-k reconstruction, mask MSE, norm regularizer, KL.

  * bootstrapped loss (reference auto_pose/ae/decoder.py:86-131): per
    sample, the per-element L2 / L1 error; keep the k = H*W*C //
    bootstrap_ratio largest and average them. As in the JAX package the
    k-th largest value is found without gradient and the errors at or
    above it are summed and divided by B * k, so the backward is an
    elementwise multiply.
  * mask MSE against the target's occupancy (decoder.py:134-142)
  * unit-norm latent regularizer (encoder.py:97-100)
  * diagonal-Gaussian KL to N(0, I) (encoder.py:87-94)
"""

from __future__ import annotations

import torch

from ..ops.kth_value import kth_largest


def bootstrapped_reconstruction_loss(
    reconstruction: torch.Tensor,
    target: torch.Tensor,
    bootstrap_ratio: int = 4,
    loss_type: str = "L2",
    topk_mode: str = "exact",
) -> torch.Tensor:
    """Mean of the top (numel // bootstrap_ratio) per-element errors of each
    sample; the plain mean error with bootstrap_ratio <= 1. `topk_mode`
    'exact' and 'sort' select the same exact k-th value; 'approx' (the
    TPU's approx_max_k) has no counterpart here and raises."""
    if topk_mode == "approx":
        raise NotImplementedError(
            "TOPK_MODE approx is the TPU's approx_max_k; the port selects exactly: use exact or sort"
        )
    if topk_mode not in ("exact", "sort"):
        raise ValueError(f"unknown topk_mode: {topk_mode!r}")
    b = reconstruction.shape[0]
    flat_r = reconstruction.reshape(b, -1)
    flat_t = target.reshape(b, -1)
    if loss_type == "L2":
        err = (flat_r - flat_t) ** 2
    elif loss_type == "L1":
        err = (flat_r - flat_t).abs()
    else:
        raise ValueError(f"unknown loss: {loss_type}")
    if bootstrap_ratio > 1:
        from ..training.profiler import span  # the training package imports the models, which import this

        k = err.shape[1] // bootstrap_ratio
        with span("loss.bootstrap"), torch.no_grad():
            mask = (err >= kth_largest(err, k)).to(err.dtype)
        return (err * mask).sum() / (err.shape[0] * k)
    return err.mean()


def mask_loss(pred_mask: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE between the predicted mask (B, H, W, 1) and the target's
    occupancy (any channel above 1e-4)."""
    occupancy = (target.sum(dim=3, keepdim=True) > 0.0001).float()
    return ((occupancy - pred_mask) ** 2).mean()


def norm_regularizer(z: torch.Tensor) -> torch.Tensor:
    """mean | ||z||_2 - 1 |: pulls the latents toward the unit sphere."""
    return (torch.linalg.vector_norm(z, dim=1) - 1.0).abs().mean()


def kl_divergence_loss(mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """KL( N(mu, sigma^2) || N(0, 1) ), mean over batch and dims."""
    sigma = torch.clamp(sigma, min=1e-8)
    kl = -torch.log(sigma) + 0.5 * (sigma**2 + mu**2) - 0.5
    return kl.mean()
