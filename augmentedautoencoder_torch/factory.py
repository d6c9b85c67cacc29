"""Build the port's inference objects from experiment names
(port of augmentedautoencoder_tpu/factory.py).

Configs and workspace paths come from the port's copies of the JAX
package's framework-neutral modules (`config`, `workspace`); checkpoints
are the port's `.pt` files (training/checkpoint.py); the embedding view
sphere is `geometry.view_sampler.viewsphere_rotations`, as the JAX
package's `Dataset.viewsphere_for_embedding` computes it.

Entry points run on the GPU unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import workspace as ws
from .codebook import Codebook, normalize_uint8
from .config import TrainConfig, load_train_config
from .geometry import view_sampler
from .models import AAE
from .parallel.distributed import all_gather_rows, in_group, rank_device
from .parallel.mesh import DATA_AXIS, batch_sharding
from .training.checkpoint import CheckpointManager

Device = Union[str, torch.device]


def default_device() -> torch.device:
    """The device of an entry point given none: the GPU, and inside a
    process group the rank's own card, `cuda:LOCAL_RANK`. Without CUDA this
    raises instead of serving on the CPU behind the caller's back."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "augmentedautoencoder_torch runs on a CUDA device and none is available; "
            'pass device="cpu" to run on the CPU'
        )
    return rank_device() if in_group() else torch.device("cuda")


def build_dataset(dataset_path: str, cfg: TrainConfig, renderer=None, render_workers: int = 0):
    """The experiment's `data.dataset.Dataset` (its training renders and
    caches, view sphere and embedding renders; the renderer is built on
    first use)."""
    from .data.dataset import Dataset  # data.dataset imports pose, which imports this module

    return Dataset(dataset_path, cfg, renderer=renderer, render_workers=render_workers)


def build_train_model(cfg: TrainConfig, device: Device, seed: int = 0) -> AAE:
    """The AAE with its decoder, for training, on `device`, its parameters
    drawn as Flax initializes them (`training.state.init_parameters_`) from
    a CPU generator seeded with `seed`, so every device starts from the same
    bits. It is built on the meta device first, so no global RNG is read."""
    from .training.state import init_parameters_

    with torch.device("meta"):
        model = AAE.from_config(cfg, train=True)
    model.to_empty(device="cpu")
    init_parameters_(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def make_encode_fn(model: AAE, mesh=None):
    """Deterministic encoder forward on the model's device: (B,H,W,C) float
    in [0,1] or uint8 (normalized on the device) -> (B, latent) f32.

    With a mesh, each rank encodes its slice of the batch along the data
    axis and the codes are gathered in batch order, so every rank returns
    the whole (B, latent), as the JAX package's sharded encode does; B must
    divide by the data axis."""

    @torch.inference_mode()
    def encode(x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = normalize_uint8(x)
        if mesh is None:
            return model.encode(x)
        return all_gather_rows(model.encode(batch_sharding(mesh, x)), mesh.get_group(DATA_AXIS))

    return encode


def make_decode_fn(model: AAE):
    """Decoder forward on the model's device: (B, latent) -> reconstruction
    (B, H, W, C) in [0, 1] (the first output with an auxiliary mask)."""
    if model.decoder is None:
        raise ValueError("make_decode_fn needs an AAE built with its decoder")

    @torch.inference_mode()
    def decode(z) -> torch.Tensor:
        z = torch.as_tensor(z, dtype=torch.float32, device=next(model.parameters()).device)
        out = model.decoder(z)
        return out[0] if model.auxiliary_mask else out

    return decode


def experiment_paths(experiment_name: str, experiment_group: str = ""):
    workspace_path = ws.get_workspace_path()
    log_dir = ws.get_log_dir(workspace_path, experiment_name, experiment_group)
    return {
        "workspace": workspace_path,
        "log_dir": log_dir,
        "checkpoint_dir": ws.get_checkpoint_dir(log_dir),
        "train_fig_dir": ws.get_train_fig_dir(log_dir),
        "dataset_path": ws.get_dataset_path(workspace_path),
        "cfg_file": ws.get_config_file_path(workspace_path, experiment_name, experiment_group),
        "exp_cfg_file": ws.get_train_config_exp_file_path(log_dir, experiment_name),
    }


def load_experiment_config(
    experiment_name: str, experiment_group: str = "", prefer_log_dir: bool = True
) -> Tuple[TrainConfig, dict]:
    """The experiment cfg; the copy in the log dir wins, as in the JAX package."""
    paths = experiment_paths(experiment_name, experiment_group)
    cfg_path = (
        paths["exp_cfg_file"]
        if prefer_log_dir and os.path.exists(paths["exp_cfg_file"])
        else paths["cfg_file"]
    )
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"config file not found: {cfg_path}")
    return load_train_config(cfg_path), paths


def embedding_viewsphere(cfg: TrainConfig) -> np.ndarray:
    """(N, 3, 3) codebook rotations in row order (renders nothing)."""
    return view_sampler.viewsphere_rotations(cfg.min_n_views, cfg.num_cyclo, cfg.radius)


def restore_experiment(
    experiment_name: str,
    experiment_group: str = "",
    at_step: Optional[int] = None,
    device: Optional[Device] = None,
    precision: Optional[str] = None,
):
    """(cfg, paths, model in eval mode on `device`, checkpoint payload). A
    multi-path experiment (MODEL_PATH of several meshes) raises: embedding
    its objects' codebooks and serving it are not supported yet."""
    cfg, paths = load_experiment_config(experiment_name, experiment_group)
    if cfg.n_objects > 1:
        raise ValueError(
            f"{experiment_name} is a multi-path model of {cfg.n_objects} objects: embedding, evaluating and "
            "serving one are not supported yet (each object needs its own codebook from the shared encoder)"
        )
    payload = CheckpointManager(paths["checkpoint_dir"]).restore(at_step)
    if payload is None:
        raise FileNotFoundError(
            f"No checkpoint found. Expected a chkpt-<step>.pt in:\n{paths['checkpoint_dir']}\n"
            "(convert a JAX checkpoint with "
            "python scripts/convert_jax_checkpoint.py <experiment>)"
        )
    model = AAE.from_config(cfg, precision=precision)
    model.load_state_dict(payload["state_dict"])
    model.to(device or default_device()).eval()
    return cfg, paths, model, payload


def build_codebook_from_name(
    experiment_name: str,
    experiment_group: str = "",
    return_dataset: bool = False,
    return_decoder: bool = False,
    at_step: Optional[int] = None,
    renderer=None,
    device: Optional[Device] = None,
):
    """Everything inference needs for one experiment, on `device`: the
    Codebook, then with `return_dataset` the experiment's `Dataset` (built
    on `renderer` if given), then with `return_decoder` the decoder's
    forward (`make_decode_fn`) or None when the checkpoint holds no
    `decoder` keys (a converted encoder-only one). Encoder and decoder
    compute in the experiment's PRECISION, as the JAX package restores them."""
    device = torch.device(device) if device is not None else default_device()
    cfg, paths, model, payload = restore_experiment(
        experiment_name, experiment_group, at_step, device
    )
    bbs = payload.get("embed_obj_bbs")
    codebook = Codebook(
        encode_fn=make_encode_fn(model),
        viewsphere=embedding_viewsphere(cfg),
        embedding_normalized=payload.get("embedding_normalized"),
        embed_obj_bbs=None if bbs is None else np.asarray(bbs.numpy()),
        num_cyclo=cfg.num_cyclo,
        device=device,
    )
    out = [codebook]
    if return_dataset:
        out.append(build_dataset(paths["dataset_path"], cfg, renderer=renderer))
    if return_decoder:
        decode = None
        if "decoder" in payload:
            full = AAE.from_config(cfg, train=True)  # cfg.precision, as the JAX restore
            full.load_state_dict({**payload["state_dict"], **payload["decoder"]})
            decode = make_decode_fn(full.to(device).eval())
        out.append(decode)
    return tuple(out) if len(out) > 1 else codebook
