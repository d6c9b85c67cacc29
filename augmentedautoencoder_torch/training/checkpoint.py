"""The port's checkpoint: one `chkpt-<step>.pt` per step.

Layout under <log_dir>/checkpoints/, beside the JAX package's orbax
`chkpt-<step>/` directories (scripts/convert_jax_checkpoint.py writes one
from the other):

    chkpt-<step>.pt   a dict of tensors, loadable with weights_only=True:
      params                 the encoder's learnable tensors
      batch_stats            its BatchNorm running statistics (may be empty)
      embedding_normalized   (N, latent) float32 codebook, if embedded
      embed_obj_bbs          (N, 4) int32 rendered boxes, if embedded
      step                   int
    and, in a checkpoint that training wrote:
      decoder                the decoder's state dict (`decoder.*` keys)
      opt_state              the optimizer's state (training/state.py)

`params` and `batch_stats` hold the encoder alone, so serving restores a
training checkpoint and a converted encoder-only one alike; training finds
its decoder and optimizer under keys of their own.

Restore takes the newest step, or the first step whose number contains
`at_step` as a substring (the JAX package's `--at_step` semantics).

Over several ranks only the primary rank writes (`save` refuses on the
others: their writes would race on the same file); every rank may read.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

from ..parallel.distributed import is_primary

_CKPT_RE = re.compile(r"^chkpt-(\d+)\.pt$")
_STAT_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def split_state_dict(state: Dict[str, torch.Tensor]):
    """(params, batch_stats) halves of an AAE state dict."""
    params = {k: v for k, v in state.items() if not k.endswith(_STAT_SUFFIXES)}
    stats = {k: v for k, v in state.items() if k.endswith(_STAT_SUFFIXES)}
    return params, stats


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


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
        opt_state: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Write chkpt-<step>.pt atomically. `decoder.*` keys of
        `state_dict` go under `decoder`, the rest is split into params and
        batch_stats. Only the primary rank of a process group writes."""
        if not is_primary():
            raise RuntimeError("only the primary rank writes checkpoints")
        encoder = {k: v for k, v in state_dict.items() if not k.startswith("decoder.")}
        decoder = {k: v for k, v in state_dict.items() if k.startswith("decoder.")}
        params, stats = split_state_dict(encoder)
        payload: Dict[str, Any] = {
            "params": _cpu(params),
            "batch_stats": _cpu(stats),
            "step": int(step),
        }
        if decoder:
            payload["decoder"] = _cpu(decoder)
        if opt_state is not None:
            payload["opt_state"] = _cpu(opt_state)
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
        return self.save(
            payload["step"], {**payload["state_dict"], **payload.get("decoder", {})},
            embedding_normalized, embed_obj_bbs, opt_state=payload.get("opt_state"),
        )

    def save_train_state(self, step: int, model: torch.nn.Module, optimizer) -> str:
        """Save the whole model (decoder included), the optimizer's state
        and the step, carrying the newest checkpoint's codebook forward so
        a periodic save does not drop it (the JAX package's
        save_train_state)."""
        emb = bbs = None
        prev = self.restore()
        if prev is not None:
            emb, bbs = prev.get("embedding_normalized"), prev.get("embed_obj_bbs")
        return self.save(step, model.state_dict(), emb, bbs, opt_state=optimizer.state_dict())

    def restore_train_state(self, model: torch.nn.Module, optimizer, at_step: Optional[int] = None):
        """Load the newest (or `at_step`) checkpoint into `model` and
        `optimizer` in place; returns the payload, or None when there is no
        checkpoint. A checkpoint without a decoder or optimizer state (an
        encoder-only one) raises: training cannot resume from it."""
        payload = self.restore(at_step)
        if payload is None:
            return None
        if "decoder" not in payload or "opt_state" not in payload:
            raise KeyError(
                f"chkpt-{payload['step']}.pt holds no decoder or optimizer state: it is a serving "
                "checkpoint (convert a JAX train state with scripts/convert_jax_checkpoint.py --train)"
            )
        model.load_state_dict({**payload["state_dict"], **payload["decoder"]})
        optimizer.load_state_dict(payload["opt_state"])
        return payload

    def restore(self, at_step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The payload dict (with `state_dict`, params and stats merged), or
        None when no checkpoint matches."""
        step = self.resolve_step(at_step)
        if step is None:
            return None
        payload = torch.load(self.path_for_step(step), map_location="cpu", weights_only=True)
        payload["state_dict"] = {**payload["params"], **payload["batch_stats"]}
        return payload
