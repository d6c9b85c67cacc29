"""`python -m augmentedautoencoder_torch.cli.ae_train <[group/]experiment>
[-gen] [-d] [--seed N]` -- train one AAE (port of
augmentedautoencoder_tpu/cli/ae_train.py).

Resolves the workspace, copies the cfg into the log dir, renders (or loads
from the cache) the training set on host threads, loads the backgrounds,
moves both onto the device and trains, resuming from the newest training
checkpoint, with a checkpoint and a reconstruction grid every
SAVE_INTERVAL (reference auto_pose/ae/ae_train.py). `-gen` only renders
the training set; `-d` writes a grid of one augmented batch instead of
training. SIGINT asks for a gentle stop: finish the step, save, exit.

A MODEL_PATH that lists n_o meshes (`['a.ply', 'b.ply', ...]`) trains one
multi-path model (models/aae.py): each object's training set is rendered
(or loaded from its own cache) as a one-object cfg of its mesh renders it,
object 0 from the run's seed and object o from the seed (seed, o), and a
step draws BATCH_SIZE / n_o rows of each (data/pipeline.py), on one device.

MODEL dsprites trains on the heart images of the .npz at MODEL_PATH
(`data.dsprites`), with no backgrounds and empty masks, as the JAX package
does; it renders nothing, so `-gen` only says so.

Runs on the GPU: without CUDA it raises unless `main` is given
device="cpu".

Over several GPUs, one process per card:

    torchrun --nproc_per_node=N -m augmentedautoencoder_torch.cli.ae_train <exp>

trains on the global batch BATCH_SIZE (which must divide by N) as one
process would (training/trainer.py). The primary rank renders or loads the
training set and the backgrounds and writes their caches while the others
wait, then they load the caches; only the primary rank writes checkpoints,
figures and summaries; a resume reads the same checkpoint on every rank.
`main` joins a process group that a caller has started (gloo on the CPU).
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
from typing import Optional, Sequence

import numpy as np
import torch

from .. import factory, parallel
from .. import workspace as ws
from ..data.dsprites import load_dsprites_training_images
from ..data.pipeline import DeviceDataset
from ..training import CheckpointManager, Trainer, make_reconstruction_fn
from ..training.metrics import MetricWriter
from ..utils import tiles
from ..utils.png import write_png
from . import split_experiment_name


def save_grid(path: str, batches, rows: int = 4) -> None:
    """Write a [inputs | reconstructions | targets] grid PNG of (B, H, W, C)
    batches in [0, 1] (the JAX package's _save_grid)."""
    n = min(rows * rows, batches[0].shape[0])
    panels = [tiles(np.asarray(b[:n]), rows, int(np.ceil(n / rows)), scale=1.0) for b in batches]
    grid = np.concatenate(panels, axis=1)
    write_png(path, (np.clip(grid, 0, 1) * 255).astype(np.uint8))


def load_device_dataset(cfg, paths, device, seed: int, gen_only: bool = False) -> Optional[DeviceDataset]:
    """Render or load the training set and the backgrounds (one
    np.random.RandomState(seed) for both, in the JAX package's order), or
    load the dsprites images, and put them on `device`; None with
    `gen_only`. A multi-path cfg renders each object after the first from
    a RandomState of (seed, object) and stacks the objects' sets."""
    rng = np.random.RandomState(seed)
    dataset = factory.build_dataset(paths["dataset_path"], cfg.for_object(0))
    if cfg.model == "dsprites":
        if gen_only:
            return None
        dataset.train_x, dataset.train_y = load_dsprites_training_images(cfg.model_path)
        dataset.mask_x = np.zeros(dataset.train_x.shape[:3], bool)
        dataset.noof_obj_pixels = dataset.mask_x.shape[1] * dataset.mask_x.shape[2] - dataset.mask_x.sum(axis=(1, 2))
        dataset.bg_imgs = np.zeros((1,) + dataset.train_x.shape[1:], np.uint8)
    else:
        dataset.get_training_images(paths["dataset_path"], rng)
        objects = [dataset]
        for o in range(1, cfg.n_objects):
            objects.append(factory.build_dataset(paths["dataset_path"], cfg.for_object(o)))
            objects[-1].get_training_images(paths["dataset_path"], np.random.RandomState([seed, o]))
        if gen_only:
            return None
        if len(objects) > 1:
            for key in ("train_x", "mask_x", "train_y", "noof_obj_pixels"):
                setattr(dataset, key, np.concatenate([getattr(d, key) for d in objects]))
        dataset.load_bg_images(paths["dataset_path"], rng)
    occlusion_masks = None
    if cfg.realistic_occlusion:
        from ..data.occlusion_masks import synthesize_mask_bank, workspace_mask_bank

        occlusion_masks = workspace_mask_bank(ws.get_workspace_path(), (cfg.h, cfg.w))
        if occlusion_masks is None:
            print("no random_tless_masks asset found; synthesizing occluders")
            occlusion_masks = synthesize_mask_bank(1000, (cfg.h, cfg.w))
    return DeviceDataset(
        cfg, dataset.train_x, dataset.mask_x, dataset.train_y, dataset.bg_imgs,
        dataset.noof_obj_pixels, occlusion_masks=occlusion_masks, device=device, n_objects=cfg.n_objects,
    )


def main(argv: Optional[Sequence[str]] = None, device=None) -> Optional[Trainer]:
    """Train the experiment on `device` (default: the GPU); returns the
    Trainer (None for -gen and -d)."""
    parser = argparse.ArgumentParser(prog="ae_train")
    parser.add_argument("experiment_name")
    parser.add_argument("-d", action="store_true", default=False,
                        help="debug: write an augmented batch grid, no training")
    parser.add_argument("-gen", action="store_true", default=False, help="generate the training data only")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    parallel.initialize(device=device)  # under torchrun: join the group, pin the card
    device = torch.device(device) if device is not None else factory.default_device()
    primary = parallel.is_primary()
    experiment_name, experiment_group = split_experiment_name(args.experiment_name)
    cfg, paths = factory.load_experiment_config(experiment_name, experiment_group, prefer_log_dir=False)
    device_ds = None
    if primary:
        for key in ("checkpoint_dir", "train_fig_dir", "dataset_path"):
            os.makedirs(paths[key], exist_ok=True)
        # the cfg is copied into the log dir and re-read at inference (ae_train.py:72)
        if os.path.abspath(paths["cfg_file"]) != os.path.abspath(paths["exp_cfg_file"]):
            shutil.copy2(paths["cfg_file"], paths["exp_cfg_file"])
        device_ds = load_device_dataset(cfg, paths, device, args.seed, gen_only=args.gen)
    parallel.barrier()  # the other ranks load the caches the primary rank wrote
    if not primary and not args.gen:
        device_ds = load_device_dataset(cfg, paths, device, args.seed)
    if device_ds is None:
        if primary:
            print("dsprites renders nothing; exiting (-gen)" if cfg.model == "dsprites"
                  else "training data generated; exiting (-gen)")
        return None
    if args.d:
        if primary:
            x, y = device_ds.sample_batch(torch.Generator(device=device).manual_seed(args.seed), cfg.batch_size)
            out = os.path.join(paths["train_fig_dir"], "debug_augmented_batch.png")
            save_grid(out, [x.cpu().numpy(), y.cpu().numpy()])
            print(f"debug grid written to {out}")
        return None

    # summaries land in the checkpoint dir, as the reference's TF FileWriter (ae_train.py:117)
    writer = MetricWriter(paths["checkpoint_dir"]) if primary else None
    trainer = Trainer(cfg, device_ds, seed=args.seed, metric_writer=writer)
    ckpt = CheckpointManager(paths["checkpoint_dir"])
    payload = ckpt.restore_train_state(trainer.model, trainer.optimizer)
    if payload is not None:
        trainer.step = int(payload["step"])
        if primary:
            print(f"resuming from step {trainer.step}")
    recon_fn = make_reconstruction_fn(trainer.model)

    def save_hook(step: int, tr: Trainer) -> None:
        ckpt.save_train_state(step, tr.model, tr.optimizer)
        # training-health figure: input | reconstruction | target, 16 rows
        # (a multiple of the objects, at least one of each)
        rows = cfg.n_objects * max(1, 16 // cfg.n_objects)
        x, y = device_ds.sample_batch(torch.Generator(device=device).manual_seed(step), rows)
        recon, _ = recon_fn(x, y)
        save_grid(os.path.join(paths["train_fig_dir"], f"training_images_{step}.png"),
                  [x.cpu().numpy(), recon.cpu().numpy(), y.cpu().numpy()])

    previous = signal.signal(signal.SIGINT, lambda sig, frame: trainer.request_stop())
    try:
        trainer.train(save_hook=save_hook, progress=primary)
    finally:
        signal.signal(signal.SIGINT, previous)
        if writer is not None:
            writer.close()
    if primary:
        print(f"done at step {trainer.step}")
    return trainer


if __name__ == "__main__":
    main()
    parallel.shutdown()
