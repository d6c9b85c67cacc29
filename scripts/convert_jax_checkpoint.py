#!/usr/bin/env python3
"""Carry a JAX experiment's checkpoint into the PyTorch port.

    python scripts/convert_jax_checkpoint.py [group/]experiment [--at_step N] [--train]

Reads the newest (or the `--at_step`) orbax `chkpt-<step>/` of the
experiment under $AE_WORKSPACE_PATH and writes `chkpt-<step>.pt` beside it
in the same checkpoints/ directory: the encoder's state dict (BatchNorm
statistics included), the codebook (`embedding_normalized`,
`embed_obj_bbs`) and the step. With `--train` it also writes the decoder
and the optimizer's state (the cfg's OPTIMIZER), so that a run the JAX
package started resumes in the port's `ae_train`. Restoring an orbax
checkpoint needs jax, so this script imports both packages and stays
outside the port, which imports neither jax nor augmentedautoencoder_tpu.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from augmentedautoencoder_torch import factory  # noqa: E402
from augmentedautoencoder_torch.cli import split_experiment_name  # noqa: E402
from augmentedautoencoder_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from augmentedautoencoder_torch.training.checkpoint import CheckpointManager  # noqa: E402


def convert(experiment_name: str, experiment_group: str = "", at_step: Optional[int] = None,
            train: bool = False) -> str:
    """Convert one experiment's checkpoint (with `train`, its decoder and
    optimizer state too); returns the written path."""
    from augmentedautoencoder_tpu.training.checkpoint import CheckpointManager as JaxCheckpoints

    paths = factory.experiment_paths(experiment_name, experiment_group)
    src = JaxCheckpoints(paths["checkpoint_dir"])
    step = src.resolve_step(at_step)
    if step is None:
        raise FileNotFoundError(f"no chkpt-<step>/ in {paths['checkpoint_dir']}")
    payload = src.restore(step)
    state = params_from_jax(payload["params"], payload.get("batch_stats"), decoder=train)
    opt_state = None
    if train:
        if "opt_state" not in payload:
            raise KeyError(f"chkpt-{step}/ holds no optimizer state: it was not written by training")
        cfg, _ = factory.load_experiment_config(experiment_name, experiment_group)
        opt_state = opt_state_from_jax(payload["opt_state"], payload["params"], cfg.optimizer)
    return CheckpointManager(paths["checkpoint_dir"]).save(
        step,
        state,
        embedding_normalized=payload.get("embedding_normalized"),
        embed_obj_bbs=payload.get("embed_obj_bbs"),
        opt_state=opt_state,
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("experiment_name", help="[group/]experiment")
    parser.add_argument("--at_step", type=int, default=None)
    parser.add_argument("--train", action="store_true", help="also carry the decoder and the optimizer state")
    args = parser.parse_args(argv)
    name, group = split_experiment_name(args.experiment_name)
    print(f"wrote {convert(name, group, args.at_step, args.train)}")


if __name__ == "__main__":
    main()
