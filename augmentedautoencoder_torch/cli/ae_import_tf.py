"""`python -m augmentedautoencoder_torch.cli.ae_import_tf <tf_ckpt_prefix>
<[group/]experiment> --cfg <train.cfg> [--scope S] [--step N]` -- import a
reference TF1 checkpoint (e.g. the published pretrained models) into the
workspace as an experiment of the port (port of
augmentedautoencoder_tpu/cli/ae_import_tf.py).

TensorFlow is not needed: `training.tf_bundle` reads the checkpoint's
`.index` and `.data-*` files with numpy. The cfg is copied to the
workspace's cfg/ and the log dir, and the weights (and the codebook, where
the checkpoint has one) are written as the port's `chkpt-<step>.pt`, the
step parsed from the prefix's `-<N>` unless given. After it, ae_embed,
ae_eval, AePoseEstimator and PoseServer work on the experiment as after
a local training.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional, Sequence

from .. import factory
from ..config import load_train_config
from ..training.tf_interop import import_reference_checkpoint
from . import split_experiment_name


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Import the checkpoint; returns the written checkpoint's path."""
    parser = argparse.ArgumentParser(prog="ae_import_tf")
    parser.add_argument("tf_checkpoint", help="TF checkpoint prefix (chkpt-NNNN)")
    parser.add_argument("experiment_name")
    parser.add_argument("--cfg", required=True, help="the experiment's train cfg")
    parser.add_argument("--scope", default=None, help="variable scope; defaults to the experiment name")
    parser.add_argument("--step", type=int, default=None,
                        help="step for the imported checkpoint (default: parsed from the TF prefix or 0)")
    args = parser.parse_args(argv)

    experiment_name, experiment_group = split_experiment_name(args.experiment_name)
    paths = factory.experiment_paths(experiment_name, experiment_group)
    os.makedirs(paths["checkpoint_dir"], exist_ok=True)

    cfg = load_train_config(args.cfg)
    # the cfg where the factory reads it (log dir and the workspace's cfg/)
    os.makedirs(os.path.dirname(paths["cfg_file"]), exist_ok=True)
    if os.path.abspath(args.cfg) != os.path.abspath(paths["cfg_file"]):
        shutil.copy2(args.cfg, paths["cfg_file"])
    shutil.copy2(args.cfg, paths["exp_cfg_file"])

    step = args.step
    if step is None:
        tail = os.path.basename(args.tf_checkpoint).rsplit("-", 1)
        step = int(tail[1]) if len(tail) == 2 and tail[1].isdigit() else 0

    scope = args.scope if args.scope is not None else experiment_name
    out = import_reference_checkpoint(
        args.tf_checkpoint, scope, paths["checkpoint_dir"], step=step,
        num_filters=tuple(cfg.num_filter), auxiliary_mask=cfg.auxiliary_mask,
        variational=bool(cfg.variational),
    )
    print(f"imported {args.tf_checkpoint} -> {out}")
    return out


if __name__ == "__main__":
    main()
