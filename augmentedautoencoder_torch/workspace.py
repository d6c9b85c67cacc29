"""Workspace layout & path conventions.

Mirrors the reference's $AE_WORKSPACE_PATH conventions exactly
(auto_pose/ae/utils.py:28-90, auto_pose/ae/ae_init_workspace.py:22-41):

  $AE_WORKSPACE_PATH/
    cfg/<group>/<experiment>.cfg         train configs
    cfg_eval/<eval>.cfg                  eval configs
    experiments/<group>/<experiment>/    log dir
      checkpoints/                       orbax checkpoints (+ codebook)
      train_figures/                     reconstruction grids
      <experiment>.cfg                   config copied at train start
    tmp_datasets/                        md5-keyed render caches
"""

from __future__ import annotations

import os
import shutil

WORKSPACE_ENV_VAR = "AE_WORKSPACE_PATH"

_TRAIN_TEMPLATE = "train_template.cfg"
_EVAL_TEMPLATE = "eval_template.cfg"


def get_workspace_path() -> str:
    ws = os.environ.get(WORKSPACE_ENV_VAR)
    if not ws:
        raise EnvironmentError(
            f"Please define a workspace path:\n  export {WORKSPACE_ENV_VAR}=/path/to/workspace"
        )
    return ws


def get_dataset_path(workspace_path: str) -> str:
    return os.path.join(workspace_path, "tmp_datasets")


def get_log_dir(workspace_path: str, experiment_name: str, experiment_group: str = "") -> str:
    return os.path.join(workspace_path, "experiments", experiment_group, experiment_name)


def get_checkpoint_dir(log_dir: str) -> str:
    return os.path.join(log_dir, "checkpoints")


def get_train_fig_dir(log_dir: str) -> str:
    return os.path.join(log_dir, "train_figures")


def get_train_config_exp_file_path(log_dir: str, experiment_name: str) -> str:
    return os.path.join(log_dir, f"{experiment_name}.cfg")


def get_checkpoint_basefilename(log_dir: str) -> str:
    return os.path.join(log_dir, "checkpoints", "chkpt")


def get_config_file_path(
    workspace_path: str, experiment_name: str, experiment_group: str = ""
) -> str:
    return os.path.join(workspace_path, "cfg", experiment_group, f"{experiment_name}.cfg")


def get_eval_config_file_path(workspace_path: str, eval_cfg: str = "eval.cfg") -> str:
    return os.path.join(workspace_path, "cfg_eval", eval_cfg)


def get_eval_dir(log_dir: str, evaluation_name: str, data: str) -> str:
    return os.path.join(log_dir, "eval", evaluation_name, data)


def init_workspace(workspace_path: str) -> None:
    """Create the workspace skeleton and copy config templates into it."""
    for sub in ("cfg", "cfg_eval", "experiments", "tmp_datasets"):
        os.makedirs(os.path.join(workspace_path, sub), exist_ok=True)

    template_dir = os.path.join(os.path.dirname(__file__), "cfg_templates")
    for name, dest_sub in ((_TRAIN_TEMPLATE, "cfg"), (_EVAL_TEMPLATE, "cfg_eval")):
        src = os.path.join(template_dir, name)
        dst = os.path.join(workspace_path, dest_sub, name)
        if not os.path.exists(src):
            raise FileNotFoundError(
                f"config template {src} is missing: the package was installed without its cfg_templates"
            )
        if not os.path.exists(dst):
            shutil.copy(src, dst)
