"""`python -m augmentedautoencoder_torch.cli.ae_init_workspace` — create the
workspace skeleton + cfg templates under $AE_WORKSPACE_PATH (reference
auto_pose/ae/ae_init_workspace.py; port of
augmentedautoencoder_tpu/cli/ae_init_workspace.py)."""

from __future__ import annotations

import os

from .. import workspace as ws


def main() -> None:
    workspace_path = ws.get_workspace_path()
    ws.init_workspace(workspace_path)
    print(f"Initialized workspace at {workspace_path}:")
    for sub in ("cfg", "cfg_eval", "experiments", "tmp_datasets"):
        print(f"  {os.path.join(workspace_path, sub)}")


if __name__ == "__main__":
    main()
