"""Profiling hooks (port of augmentedautoencoder_tpu/training/profiler.py):
`trace(log_dir)` records a torch.profiler trace (host and, where there is
one, CUDA activity) of a code region as a Chrome trace file, `span(name)`
marks a region of the program in whatever trace is recording, and
`StageTimer` sums named host-side stage durations (kept for BOP per-image
time accounting, compute_bop_results_m3.py:175-177).

The training step's spans, each `aae.<name>` in the trace, on the thread
that issues the work (a step's spans nest inside its `aae.train.step`; the
N-th `aae.train.step` of a trace is the N-th step traced):

  train.step           one iteration of `Trainer._loop`: the step's seed,
                       the step, the log block, a flush, a save
  train.sample_batch   the batch's draws and composition on the device
  train.forward        the model's forward and its losses
  train.backward       zero_grad and the backward call (the autograd
                       engine's own threads run its operators meanwhile)
  train.optimizer      the optimizer's update
  train.log            stacking the logged losses, their pinned copy and event
  train.flush          reading pending losses back (waits on the device)
  train.save           the save hook and the ranks' barrier
  ops.phase_kernels    the fused 2x convolution's phase kernels (forward: a
                       gather and the ordered additions; no copy, no wait)
  loss.bootstrap       the bootstrapped loss's k-th value and mask (forward)
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import ContextManager, Dict, Iterator

import torch

SPAN_PREFIX = "aae."

_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A `record_function` range `aae.<name>` while a torch.profiler records,
    so the region lands in its trace on the clock of the kernels it
    launches; otherwise one shared no-op context. The gate keeps the cost
    off untraced runs: an idle `record_function` costs a CPU core ~7 us, the
    check ~0.3 us. A span adds no device work and no synchronization."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the region with torch.profiler, yielding the profile (for
    its `key_averages()`), and write `<log_dir>/trace.json` (open in
    Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulate named stage wall-times; `summary()` -> {name: (total, n)}.
    Each stage is also a `span(name)`, so it shows in a recording trace."""

    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self._totals[name] += dt
            self._counts[name] += 1

    def total(self, name: str) -> float:
        return self._totals[name]

    def mean(self, name: str) -> float:
        n = self._counts[name]
        return self._totals[name] / n if n else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self._totals[k], "count": self._counts[k],
                "mean_s": self.mean(k)}
            for k in self._totals
        }
