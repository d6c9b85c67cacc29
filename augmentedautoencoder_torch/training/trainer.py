"""The training step and the training loop (port of
augmentedautoencoder_tpu/training/trainer.py).

One step: batch draw and composite on the device (data/pipeline.py), AAE
forward with the bootstrapped loss in the model's precision, backward, and
the optax-exact update of the f32 parameters (training/state.py). Its
random numbers come from a generator on the device seeded from (seed,
step), so a run is reproducible from its seed and resumes mid-stream; the
initial parameters come from a seed disjoint from every step's, as the JAX
package folds 2**31 - 1 into its key for them.

The loop keeps the reference's save cadence, stops gently on
`request_stop` (SIGINT), and reads its losses back late: the logged losses
of a step are stacked into one device vector and copied without blocking
into pinned host memory, and their values are read 50 logs later, or at a
save, or when the loop ends, even by an exception. No step waits for the
device to report a loss.

Each iteration and its parts are `profiler.span`s (listed there): free
unless a torch.profiler is recording, then on the trace's clock with the
kernels they launch.

Over several ranks (a process group, one process per card, the data axis
of a `parallel` mesh) a run computes what one process computes on the
global batch, up to summation order, as the JAX step over a data mesh
does: every rank draws the global batch's random numbers from the step's
generator and composes its slice (data/pipeline.py), BatchNorm takes the
global batch's statistics (`models.encoder.sync_batch_norm`), DDP averages
the gradients (the ranks' slices are equal, so the average of their means
is the global mean), the logged losses are reduced to the global batch's,
and the primary rank alone saves, the others waiting at a barrier.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..codebook import f32_without_tf32
from ..data.pipeline import DeviceDataset
from ..models.encoder import sync_batch_norm
from ..parallel.distributed import barrier, is_primary, world_size
from ..parallel.mesh import DATA_AXIS, axis_index, axis_size, make_mesh
from .profiler import span
from .state import make_optimizer

Losses = Dict[str, torch.Tensor]

#: the init seed's tag, outside the range of step numbers
INIT_TAG = 2**31 - 1


def derive_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for (seed, tag), mixed by numpy's SeedSequence: distinct
    tags give unrelated streams."""
    a, b = np.random.SeedSequence([int(seed), int(tag)]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def data_parallel(model, mesh):
    """`model` wrapped for the mesh's data axis: DDP over the axis's group
    (pinned to the model's card on CUDA) and, with more than one rank,
    BatchNorm on the global batch's statistics. `broadcast_buffers` is off:
    the global statistics leave every rank's running statistics equal, so
    a broadcast each step would move bytes for nothing."""
    group = mesh.get_group(DATA_AXIS)
    if axis_size(mesh, DATA_AXIS) > 1:
        sync_batch_norm(model, group)
    device = next(model.parameters()).device
    with warnings.catch_warnings():
        # newer torch renames the flag forward_sync_buffers (and warns); the
        # card's torch knows only this one, and its meaning is the one wanted
        warnings.filterwarnings("ignore", message="`broadcast_buffers` is deprecated", category=FutureWarning)
        return torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None, process_group=group,
            broadcast_buffers=False,
        )


def make_train_step(
    model, optimizer, dataset: DeviceDataset, batch_size: int, mesh=None
) -> Callable[[torch.Generator], Losses]:
    """(generator) -> losses of one step: draw and compose a batch, forward
    and backward in training mode (batch statistics), one optimizer
    update. The returned losses are detached device scalars.

    With a mesh, `batch_size` is the global batch, which must divide by the
    data axis; this rank composes its slice and steps `data_parallel(model,
    mesh)`, and its losses are its slice's (`Trainer` reduces the logged
    ones to the global batch's)."""
    shard = (0, 1)
    if mesh is not None:
        if getattr(model, "n_objects", 1) > 1:
            raise ValueError(
                f"a multi-path model ({model.n_objects} objects) trains on one device for now: "
                "run it without torchrun or a process group"
            )
        shard = (axis_index(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS))
        if batch_size % shard[1]:
            raise ValueError(f"BATCH_SIZE {batch_size} does not divide over {shard[1]} data ranks")
        model = data_parallel(model, mesh)

    def step(gen: torch.Generator) -> Losses:
        with span("train.sample_batch"):
            x, y = dataset.sample_batch(gen, batch_size, shard)
        model.train()
        with span("train.forward"):
            out = model(x, y, train=True, generator=gen, shard=shard)
        with span("train.backward"):
            optimizer.zero_grad()
            out.total_loss.backward()
        with span("train.optimizer"):
            optimizer.step()
        return {k: v.detach() for k, v in out.losses.items()}

    return step


def make_reconstruction_fn(model):
    """(x, y) -> (reconstruction, losses) with the running statistics and
    no gradient, for the training-health image grids (ae_train.py:137-148)."""

    @torch.no_grad()
    def fn(x: torch.Tensor, y: torch.Tensor):
        was_training = model.training
        model.eval()
        try:
            out = model(x, y, train=False)
        finally:
            model.train(was_training)
        return out.reconstruction, out.losses

    return fn


def global_losses(vec: torch.Tensor, names: List[str], group) -> torch.Tensor:
    """The ranks' logged losses (a vector in `names` order) as one process
    logs them on the global batch: each is a mean over equal slices, so its
    average over the ranks, except `z_std`, rebuilt from the ranks' means
    of z and z^2."""
    vec = vec.clone()
    std = names.index("z_std") if "z_std" in names else None
    if std is not None:
        mean = names.index("z_mean")
        vec[std] = vec[std] * vec[std] + vec[mean] * vec[mean]
    torch.distributed.all_reduce(vec, group=group)
    vec /= torch.distributed.get_world_size(group)
    if std is not None:
        vec[std] = torch.sqrt(torch.clamp(vec[std] - vec[mean] * vec[mean], min=0.0))
    return vec


class Trainer:
    """The training loop with the reference's save and summary cadence.
    `step` counts the updates made, as the JAX TrainState.step. Inside a
    process group of more than one rank it builds the data mesh itself
    (`parallel.make_mesh`), as the JAX Trainer does over several devices;
    `model` stays the bare module (checkpoints, grids), the step runs its
    DDP wrapper."""

    def __init__(self, cfg, dataset: DeviceDataset, seed: int = 0, metric_writer=None, mesh=None):
        from ..factory import build_train_model  # factory imports this package

        self.cfg = cfg
        self.dataset = dataset
        self.device = dataset.device
        self.seed = int(seed)
        self.mesh = mesh if mesh is not None else (make_mesh() if world_size() > 1 else None)
        self.model = build_train_model(cfg, self.device, derive_seed(seed, INIT_TAG))
        self.optimizer = make_optimizer(self.model, cfg)
        self.step = 0
        self.step_fn = make_train_step(self.model, self.optimizer, dataset, cfg.batch_size, self.mesh)
        self.generator = torch.Generator(device=self.device)
        self.metric_writer = metric_writer
        self._stop_requested = False
        #: host clock (time.perf_counter) when each step of the last
        #: `train` call had been issued
        self.step_end_times: List[float] = []

    def request_stop(self) -> None:
        """Gentle SIGINT-style stop: finish the current iteration, save,
        exit (reference ae_train.py:30-34). Over several ranks every rank
        must be asked (torchrun passes a terminal's Ctrl-C to each)."""
        self._stop_requested = True

    def generator_for(self, step: int) -> torch.Generator:
        """The device generator of one step, seeded from (seed, step)."""
        return self.generator.manual_seed(derive_seed(self.seed, step))

    def train(
        self,
        num_iter: Optional[int] = None,
        save_hook: Optional[Callable[[int, "Trainer"], None]] = None,
        log_every: int = 10,
        progress: bool = True,
    ) -> int:
        """Run to `num_iter` (cfg NUM_ITER) steps from the current step;
        returns the step reached. `save_hook(step, trainer)` runs every
        SAVE_INTERVAL steps, at the end and at a requested stop."""
        num_iter = num_iter or self.cfg.num_iter
        pending: List[Tuple[int, List[str], torch.Tensor, Optional[torch.cuda.Event]]] = []

        def flush_pending():
            last = None
            with span("train.flush"):
                for step, names, host, done in pending:
                    if done is not None:
                        done.synchronize()
                    last = dict(zip(names, host.tolist()))
                    if self.metric_writer:
                        self.metric_writer.write_scalars(step, last)
                pending.clear()
            return last

        try:
            # no TF32: an f32 step in full f32, and under PRECISION bfloat16
            # the f32 heads, the loss and the optimizer
            with f32_without_tf32():
                self._loop(num_iter, save_hook, log_every, progress, pending, flush_pending)
        finally:
            # an exception in a step must not lose the metrics closest to it
            flush_pending()
        return self.step

    def _loop(self, num_iter, save_hook, log_every, progress, pending, flush_pending) -> None:
        start, t0 = self.step, time.time()
        cuda = self.device.type == "cuda"
        self.step_end_times = []
        for i in range(start, num_iter):
            with span("train.step"):
                losses = self.step_fn(self.generator_for(i))
                self.step = i + 1
                self.step_end_times.append(time.perf_counter())
                # every rank reduces at the same steps, whatever it writes
                if self.step % log_every == 0 and (self.metric_writer or progress or self.mesh is not None):
                    with span("train.log"):
                        names = list(losses)
                        vec = torch.stack([losses[k].float() for k in names])
                        if self.mesh is not None:
                            vec = global_losses(vec, names, self.mesh.get_group(DATA_AXIS))
                        host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=cuda)
                        host.copy_(vec, non_blocking=cuda)
                        done = None
                        if cuda:
                            done = torch.cuda.Event()
                            done.record()
                        pending.append((self.step, names, host, done))
                    if self.step % (log_every * 50) == 0:
                        host_losses = flush_pending()
                        if progress:
                            rate = (self.step - start) / (time.time() - t0)
                            print(f"[{self.step}/{num_iter}] "
                                  + " ".join(f"{k}={v:.5f}" for k, v in host_losses.items())
                                  + f" ({rate:.1f} it/s)", flush=True)
                if save_hook and (self.step % self.cfg.save_interval == 0 or self.step == num_iter):
                    flush_pending()
                    self._save(save_hook)
                if self._stop_requested:
                    flush_pending()
                    if save_hook:
                        self._save(save_hook)
                    break

    def _save(self, save_hook) -> None:
        """The hook on the primary rank; the others wait until it is done."""
        with span("train.save"):
            if is_primary():
                save_hook(self.step, self)
            barrier()

