"""The port's checkpoint: one `chkpt-<step>.pt` per step.

Layout under <log_dir>/checkpoints/, beside the JAX package's orbax
`chkpt-<step>/` directories (scripts/convert_jax_checkpoint.py writes one
from the other):

    chkpt-<step>.pt   a dict of tensors, loadable with weights_only=True:
      params                 the AAE state dict's learnable tensors
      batch_stats            BatchNorm running statistics (may be empty)
      embedding_normalized   (N, latent) float32 codebook, if embedded
      embed_obj_bbs          (N, 4) int32 rendered boxes, if embedded
      step                   int

Restore takes the newest step, or the first step whose number contains
`at_step` as a substring (the JAX package's `--at_step` semantics).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_CKPT_RE = re.compile(r"^chkpt-(\d+)\.pt$")
_STAT_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def split_state_dict(state: Dict[str, torch.Tensor]):
    """(params, batch_stats) halves of an AAE state dict."""
    params = {k: v for k, v in state.items() if not k.endswith(_STAT_SUFFIXES)}
    stats = {k: v for k, v in state.items() if k.endswith(_STAT_SUFFIXES)}
    return params, stats


class CheckpointManager:
    """Save/restore the port's checkpoint files under a checkpoint dir."""

    def __init__(self, checkpoint_dir: str):
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)

    def path_for_step(self, step: int) -> str:
        return os.path.join(self.checkpoint_dir, f"chkpt-{step}.pt")

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.checkpoint_dir):
            return []
        steps = []
        for name in os.listdir(self.checkpoint_dir):
            m = _CKPT_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def resolve_step(self, at_step: Optional[int] = None) -> Optional[int]:
        steps = self.all_steps()
        if at_step is None:
            return steps[-1] if steps else None
        for s in steps:
            if str(at_step) in str(s):
                return s
        return None

    def save(
        self,
        step: int,
        state_dict: Dict[str, torch.Tensor],
        embedding_normalized=None,
        embed_obj_bbs=None,
    ) -> str:
        params, stats = split_state_dict(state_dict)
        payload: Dict[str, Any] = {
            "params": {k: v.detach().cpu() for k, v in params.items()},
            "batch_stats": {k: v.detach().cpu() for k, v in stats.items()},
            "step": int(step),
        }
        if embedding_normalized is not None:
            payload["embedding_normalized"] = torch.as_tensor(embedding_normalized, dtype=torch.float32).cpu()
        if embed_obj_bbs is not None:
            payload["embed_obj_bbs"] = torch.as_tensor(embed_obj_bbs, dtype=torch.int32).cpu()
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = self.path_for_step(step)
        tmp = f"{path}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def add_codebook(self, embedding_normalized, embed_obj_bbs, step: Optional[int] = None) -> str:
        """Re-save the latest (or given) checkpoint with the codebook inside
        (the ae_embed re-save, reference ae_embed.py:87-91): the embedding
        as f32 and, if given, the rendered boxes as int32; without boxes the
        checkpoint keeps the ones it had, as in the JAX package."""
        payload = self.restore(step)
        if payload is None:
            raise FileNotFoundError(f"no checkpoint in {self.checkpoint_dir}")
        if embed_obj_bbs is None:
            embed_obj_bbs = payload.get("embed_obj_bbs")
        return self.save(payload["step"], payload["state_dict"], embedding_normalized, embed_obj_bbs)

    def restore(self, at_step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The payload dict (with `state_dict`, params and stats merged), or
        None when no checkpoint matches."""
        step = self.resolve_step(at_step)
        if step is None:
            return None
        payload = torch.load(self.path_for_step(step), map_location="cpu", weights_only=True)
        payload["state_dict"] = {**payload["params"], **payload["batch_stats"]}
        return payload
