"""Profiling hooks (port of augmentedautoencoder_tpu/training/profiler.py):
`trace(log_dir)` records a torch.profiler trace (host and, where there is
one, CUDA activity) of a code region as a Chrome trace file, and
`StageTimer` sums named host-side stage durations (kept for BOP per-image
time accounting, compute_bop_results_m3.py:175-177).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the region with torch.profiler, yielding the profile (for
    its `key_averages()`), and write `<log_dir>/trace.json` (open in
    Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulate named stage wall-times; `summary()` -> {name: (total, n)}."""

    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
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
