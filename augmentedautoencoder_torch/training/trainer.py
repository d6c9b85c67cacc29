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
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..codebook import f32_without_tf32
from ..data.pipeline import DeviceDataset
from .state import make_optimizer

Losses = Dict[str, torch.Tensor]

#: the init seed's tag, outside the range of step numbers
INIT_TAG = 2**31 - 1


def derive_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for (seed, tag), mixed by numpy's SeedSequence: distinct
    tags give unrelated streams."""
    a, b = np.random.SeedSequence([int(seed), int(tag)]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def make_train_step(model, optimizer, dataset: DeviceDataset, batch_size: int) -> Callable[[torch.Generator], Losses]:
    """(generator) -> losses of one step: draw and compose a batch, forward
    and backward in training mode (batch statistics), one optimizer
    update. The returned losses are detached device scalars."""

    def step(gen: torch.Generator) -> Losses:
        x, y = dataset.sample_batch(gen, batch_size)
        model.train()
        out = model(x, y, train=True, generator=gen)
        optimizer.zero_grad()
        out.total_loss.backward()
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


class Trainer:
    """The training loop with the reference's save and summary cadence.
    `step` counts the updates made, as the JAX TrainState.step."""

    def __init__(self, cfg, dataset: DeviceDataset, seed: int = 0, metric_writer=None):
        from ..factory import build_train_model  # factory imports this package

        self.cfg = cfg
        self.dataset = dataset
        self.device = dataset.device
        self.seed = int(seed)
        self.model = build_train_model(cfg, self.device, derive_seed(seed, INIT_TAG))
        self.optimizer = make_optimizer(self.model, cfg)
        self.step = 0
        self.step_fn = make_train_step(self.model, self.optimizer, dataset, cfg.batch_size)
        self.generator = torch.Generator(device=self.device)
        self.metric_writer = metric_writer
        self._stop_requested = False
        #: host clock (time.perf_counter) when each step of the last
        #: `train` call had been issued
        self.step_end_times: List[float] = []

    def request_stop(self) -> None:
        """Gentle SIGINT-style stop: finish the current iteration, save,
        exit (reference ae_train.py:30-34)."""
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
            losses = self.step_fn(self.generator_for(i))
            self.step = i + 1
            self.step_end_times.append(time.perf_counter())
            if self.step % log_every == 0 and (self.metric_writer or progress):
                names = list(losses)
                vec = torch.stack([losses[k].float() for k in names])
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
                save_hook(self.step, self)
            if self._stop_requested:
                flush_pending()
                if save_hook:
                    save_hook(self.step, self)
                break

