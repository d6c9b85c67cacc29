"""`python -m augmentedautoencoder_torch.cli.ae_embed <[group/]experiment>
[--at_step N] [--batch_size B]` -- build the codebook (port of
augmentedautoencoder_tpu/cli/ae_embed.py).

Renders every embedding view on the host, encodes the views on the GPU in
the experiment's PRECISION (bf16 convolutions, f32 latent head) and
re-saves the experiment's `chkpt-<step>.pt` with the normalized embedding
and, with EMBED_BB, the per-view rendered boxes inside (reference
auto_pose/ae/ae_embed.py:53-93). MODEL dsprites embeds the 40-image
orientation codebook of `data.dsprites.codebook_images` instead, without
boxes, as the JAX package does. Runs on the GPU: without CUDA it raises
unless `main` is given device="cpu".

Over several GPUs, one process per card:

    torchrun --nproc_per_node=N -m augmentedautoencoder_torch.cli.ae_embed <exp>

each rank renders and encodes its own contiguous run of the view batches
(its own render thread: the build is bound by the host render) and the
primary rank writes the gathered codebook, whose rows equal the
one-process build's. `main` joins a process group that a caller has
started (gloo on the CPU).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import factory, parallel
from ..codebook import Codebook, f32_without_tf32
from ..data.dsprites import codebook_images, load_dsprites_training_images
from ..training.checkpoint import CheckpointManager
from . import split_experiment_name


def main(argv: Optional[Sequence[str]] = None, device=None, profile: Optional[Dict[str, float]] = None) -> str:
    """Embed the experiment's codebook on `device` (default: the GPU);
    returns the checkpoint path. `profile` receives build_embedding's time
    split."""
    parser = argparse.ArgumentParser(prog="ae_embed")
    parser.add_argument("experiment_name")
    parser.add_argument("--at_step", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    args = parser.parse_args(argv)

    parallel.initialize(device=device)  # under torchrun: join the group, pin the card
    device = torch.device(device) if device is not None else factory.default_device()
    primary = parallel.is_primary()
    experiment_name, experiment_group = split_experiment_name(args.experiment_name)
    # the model in the cfg's PRECISION, as the JAX ae_embed restores it
    cfg, paths, model, _ = factory.restore_experiment(experiment_name, experiment_group, args.at_step, device)
    mgr = CheckpointManager(paths["checkpoint_dir"])
    path = mgr.path_for_step(mgr.resolve_step(args.at_step))
    if cfg.model == "dsprites":
        # the orientation codebook from the pinned-latent images (reference
        # codebook.py:164-185): 40 rows, built by the primary rank alone
        if primary:
            _, train_y = load_dsprites_training_images(cfg.model_path)
            with f32_without_tf32():
                z = factory.make_encode_fn(model)(torch.from_numpy(codebook_images(train_y)).to(device)).cpu().numpy()
            z /= np.linalg.norm(z, axis=1, keepdims=True)
            path = mgr.add_codebook(z, None, step=args.at_step)
            print(f"dsprites codebook ({z.shape[0]} x {z.shape[1]}) saved into {path}")
        parallel.barrier()
        return path
    dataset = factory.build_dataset(paths["dataset_path"], cfg)
    batch_size = args.batch_size or max(cfg.batch_size, 256)
    mesh = parallel.make_mesh() if parallel.world_size() > 1 else None
    if primary:
        ranks = "" if mesh is None else f" over {parallel.axis_size(mesh, parallel.DATA_AXIS)} ranks"
        print(f"embedding {dataset.embedding_size} views (batch {batch_size}) on {device}{ranks} ...")
    embedding, obj_bbs = Codebook.build_embedding(
        factory.make_encode_fn(model), dataset.render_embedding_image_batch, dataset.embedding_size,
        batch_size, progress=primary, device=device, profile=profile, mesh=mesh,
    )
    if primary:
        path = mgr.add_codebook(embedding, obj_bbs if cfg.embed_bb else None, step=args.at_step)
        print(f"codebook ({embedding.shape[0]} x {embedding.shape[1]}) saved into {path}")
    parallel.barrier()
    return path


if __name__ == "__main__":
    main()
    parallel.shutdown()
