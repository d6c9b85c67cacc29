"""Training traffic over several cards: one rank of a data-parallel run of
`Trainer.train`, as `torchrun --nproc_per_node=N ... ae_train` runs it.
`run.py` starts one process a card with torchrun's variables (WORLD_SIZE,
RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), and each runs `run` here.

The pieces are `kinds/train.py`'s; what differs is the order of set-up
and the window. The process group is joined first. Rank 0 loads the render
pool (rendering it on a checkout's first run) while the others wait, then
they load its cache. Every rank builds the trainer (which builds its data
mesh and steps DDP over it), takes the run's weights, and runs the same
checked, warm-up and traced steps; only rank 0 runs the profiler.

The window cannot be closed by a timer: each rank's trainer stops on its
own flag, ranks whose timers fire at different steps stop at different
steps, and those that go on wait forever in the gradients' all-reduce. So
rank 0 times its last warm-up steps, sets the window's step count from
them and broadcasts it, and every rank runs exactly that many steps. Rank
0 times the window from a barrier after a synchronize to a synchronize and
a barrier after the last step. No collective is added inside it.

`correct`: rank 0's checked steps against the reference on the global
batch (every rank draws the global batch's numbers and composes its slice,
so the one-card reference applies as it is), and the ranks' parameters
alike bit for bit before and after the window. The reference runs on rank
0 once the program's state is freed; the others wait at a barrier.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..metrics import _flops, _params
from ..readings import Readings
from ..reference import compare, model
from . import train
from .train import breakdown  # noqa: F401 (run.py finds a kind's breakdown on it)


def load_pool(config: dict, traffic: dict, data_dir: str):
    """The pool's arrays on every rank of the group: rank 0 loads them first
    (rendering and caching them on a checkout's first run) while the others
    wait, then they load its cache."""
    from augmentedautoencoder_torch.parallel import distributed

    pool = None
    for turn in (True, False):
        if distributed.is_primary() == turn:
            cfg, pool_dir = train.parse(config, traffic, data_dir)
            pool = train.load_pool(config, cfg, pool_dir)
        distributed.barrier()
    return pool


def ranks_unlike(trainer) -> int:
    """The ranks whose parameters differ from rank 0's: each leaf's sum and
    sum of squares in float64, gathered and compared exactly."""
    sums = torch.stack([torch.stack([p.detach().double().sum(), p.detach().double().square().sum()])
                        for p in trainer.model.parameters()]).flatten()
    gathered = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, sums)
    return sum(1 for g in gathered[1:] if not torch.equal(g, gathered[0]))


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device, data_dir: str,
        limits: Dict[str, float], t_start: float, clock=time.monotonic) -> dict:
    """One rank's run. `t_start` is the launcher's start on `clock`, which
    every process of the machine shares."""
    from augmentedautoencoder_torch.parallel import distributed

    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    marks = {"imported": clock() - t_start}
    distributed.initialize(device=device)
    primary, world = distributed.is_primary(), distributed.world_size()
    marks["joined"] = clock() - t_start
    pool = load_pool(config, traffic, data_dir)
    marks["pool"] = clock() - t_start
    trainer, recorder, pool_np = train.build(config, traffic, seed, device, data_dir, pool)
    marks["built"] = clock() - t_start
    if trace:
        train.install_spans(trainer)
    rec = train.check_steps(trainer, recorder, traffic["check_steps"])
    marks["checked"] = clock() - t_start
    log_every = traffic["log_every"]
    warm = traffic["warmup_steps"]
    timed = max(1, warm // 2)
    trainer.train(num_iter=trainer.step + warm - timed, log_every=log_every, progress=False)
    sync()
    t = clock()
    trainer.train(num_iter=trainer.step + timed, log_every=log_every, progress=False)
    sync()
    step_s = (clock() - t) / timed
    marks["warm"] = clock() - t_start
    arch = model.Arch(config["cfg"])
    readings = Readings(
        precision=train.precision_of(config),
        step_ops=_flops.step_ops(arch.h, arch.w, arch.c, arch.filters, arch.k_enc, arch.k_dec, arch.latent,
                                 traffic["batch_size"] // world, train.precision_of(config)),
        grad_bytes=_params.grad_bytes(arch.h, arch.w, arch.c, arch.filters, arch.k_enc, arch.k_dec, arch.latent))
    if trace:
        if primary:
            readings.trace = train.traced_stretch(trainer, traffic["trace_steps"], log_every, sync)
            readings.steps_traced = traffic["trace_steps"]
        else:
            trainer.train(num_iter=trainer.step + traffic["trace_steps"], log_every=log_every, progress=False)
    unlike = ranks_unlike(trainer)
    # the window's step count, rank 0's, on every rank
    steps_t = torch.tensor([math.ceil(seconds / step_s)], dtype=torch.int64, device=device)
    dist.broadcast(steps_t, src=0)
    steps = int(steps_t.item())

    # the window
    recorder.rows.clear()
    sync()
    distributed.barrier()
    setup_s = clock() - t_start
    t0 = clock()
    start = trainer.step
    trainer.train(num_iter=start + steps, log_every=log_every, progress=False)
    sync()
    distributed.barrier()
    window_s = clock() - t0
    # the pace through the window: the median interval between steps issued, in each tenth
    issued = np.diff(trainer.step_end_times) * 1e3
    pace = [float(np.median(part)) for part in np.array_split(issued, 10) if len(part)]
    readings.window_steps, readings.window_s = trainer.step - start, window_s
    unlike = max(unlike, ranks_unlike(trainer))
    logged = list(recorder.rows.values())
    failed = sum(1 for row in logged if not all(math.isfinite(v) for v in row.values()))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the reference on rank 0, once the program's state is freed
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, ref_s = {k: math.nan for k in compare.NUMBERS}, 0.0
    if primary:
        t_ref = clock()
        numbers = compare.compare(rec, train.reference(config, traffic, seed, device, pool_np))
        ref_s = clock() - t_ref
    distributed.barrier()
    distributed.shutdown()
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    checks["ranks_unlike"] = {"value": unlike, "limit": 0}
    return {
        "correct": compare.judge(numbers, limits) and failed == 0 and unlike == 0,
        "attempted": steps,
        "failed": failed,
        "end_to_end": {"train_samples_per_s": steps * traffic["batch_size"] / window_s, "setup_s": setup_s},
        "readings": readings,
        "memory_peak_bytes": int(peak),
        "checks": checks,
        "notes": {"setup_marks_s": marks, "window_s": window_s, "steps": steps, "warm_step_s": step_s,
                  "pace_ms_tenths": pace, "ranks": world, "reference_s": ref_s},
    }
