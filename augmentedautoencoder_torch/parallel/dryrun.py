"""The multi-GPU dry run (counterpart of the JAX package's
`__graft_entry__.dryrun_multichip` / `_dryrun_impl`), and `run_ranks`, which
starts the ranks of a process group from one Python process.

`dryrun_multigpu(world, device)` runs, in `world` spawned ranks:

  * full train steps of the data-parallel Trainer against the one-process
    step from the same state and generator (loss, every gradient, every
    BatchNorm statistic, and the update given the same gradients), and the
    ranks' parameters equal after the run;
  * the weak-scaling shard shapes: the per-rank batch stays constant as the
    data axis grows;
  * the row-sharded top-1 (B3) and top-k (B2) queries against the
    replicated kernel, with a row duplicated across two shards (the lowest
    global index wins).

On the CPU the ranks use gloo; on CUDA each rank takes its own card over
NCCL, or, with more ranks than cards, all ranks share card 0 over gloo
(NCCL refuses two ranks on one device; gloo carries CUDA tensors for the
all-reduce, broadcast and all-gather these paths use). A rank that fails
fails the run.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .distributed import initialize, shutdown
from .mesh import DATA_AXIS, axis_size, codebook_sharding, make_mesh, shard_range

#: bounds of one train step, W ranks against one process (the JAX dry run's
#: 1e-4 on the loss; phase 7's on a gradient, of its tensor's largest
#: |value|, and on the update given the same gradients)
LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-2
UPDATE_TOL = 2e-6
#: BatchNorm's running statistics after a step (tests/test_torch_training.py's
#: bound on a parameter or statistic)
STAT_TOL = 1e-5
#: query bounds: indices equal where the replicated ranking's margin exceeds
#: MARGIN, values within VAL_TOL
MARGIN = 1e-5
VAL_TOL = 1e-5
#: the queries of the sharded check: a serving chunk of 8 detections, top-8
QUERIES, K = 8, 8


def rank_devices(world: int, device: str):
    """(devices, backend) of `world` ranks on `device` ("cpu" or "cuda"): the
    CPU over gloo; a card each over NCCL; card 0 shared over gloo when
    there are more ranks than cards."""
    if device == "cpu":
        return [torch.device("cpu")] * world, "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("rank_devices: no CUDA device")
    cards = torch.cuda.device_count()
    if world <= cards:
        return [torch.device("cuda", r) for r in range(world)], "nccl"
    return [torch.device("cuda", 0)] * world, "gloo"


def run_ranks(fn: Callable, world: int, device: str, *args, timeout: float = 900.0) -> List:
    """`fn(rank_device, *args)` in `world` spawned processes joined in one
    process group (a `file://` rendezvous in a temporary directory), each
    rank pinned to its device (`rank_devices`). Returns the ranks' results in
    rank order (torch.save'd by each rank). Raises if a rank raises or the
    ranks outlive `timeout` seconds; the others are then terminated. `fn`
    must be importable by the spawned processes (a module-level function)."""
    import torch.multiprocessing as mp

    devices, backend = rank_devices(world, device)
    with tempfile.TemporaryDirectory(prefix="aae_ranks_") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        ctx = mp.start_processes(
            _rank_entry, args=(world, init, devices, backend, tmp, fn, args), nprocs=world,
            join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"run_ranks: {world} ranks of {fn.__name__} still running after {timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _rank_entry(rank, world, init_method, devices, backend, out_dir, fn, args):
    device = devices[rank]
    if device.type == "cuda":
        os.environ["LOCAL_RANK"] = str(device.index)
    else:  # one intra-op thread a CPU rank, as torchrun sets OMP_NUM_THREADS=1: the ranks are the parallelism
        torch.set_num_threads(1)
    initialize(init_method, world, rank, device=device, backend=backend)
    try:
        torch.save(fn(device, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown()


# ------------------------------------------------------------------ the dry run
def dryrun_config(world: int):
    """The JAX dry run's configuration: 32x32x3, filters [8, 16], latent 16,
    batch 2 per rank, square occlusion, a 4-op augmentation."""
    from ..config import TrainConfig
    from ..data import augment_spec as S

    cfg = TrainConfig(h=32, w=32, c=3, latent_space_size=16)
    cfg.num_filter = [8, 16]
    cfg.strides = [2, 2]
    cfg.batch_size = 2 * world
    cfg.square_occlusion = 0.25
    cfg.code = S.Sequential([
        S.Sometimes(0.5, S.Affine(scale=(1.0, 1.2))),
        S.Sometimes(0.5, S.CoarseDropout(p=0.2, size_percent=0.05)),
        S.Sometimes(0.5, S.Add(value=(-25, 25), per_channel=0.3)),
        S.Sometimes(0.5, S.Multiply(mul=(0.6, 1.4))),
    ])
    return cfg


def dryrun_dataset(cfg, device, n: int = 64, n_bg: int = 16, seed: int = 0):
    """Seeded uint8 renders, masks and backgrounds at the cfg's shape on
    `device` (the JAX dry run's arrays)."""
    from ..data.pipeline import DeviceDataset

    rng = np.random.RandomState(seed)
    x = rng.randint(0, 255, (n, cfg.h, cfg.w, cfg.c), dtype=np.uint8)
    masks = rng.rand(n, cfg.h, cfg.w) > 0.7
    bg = rng.randint(0, 255, (n_bg, cfg.h, cfg.w, cfg.c), dtype=np.uint8)
    return DeviceDataset(cfg, x, masks, x.copy(), bg, device=device)


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b| (0 for two zero tensors)."""
    scale = float(b.abs().max())
    diff = float((a - b).abs().max())
    return diff / scale if scale > 0 else diff


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_rank(device, cfg, seed: int, steps: int, time_steps: int = 0) -> Dict:
    """One rank of the dry run's training check (and, with `time_steps`,
    host ms a step at the cfg's global batch and at the cfg's batch per
    rank). Rank 0 steps a one-process model beside the Trainer, from the
    Trainer's state before each step, and measures how far apart they are."""
    from ..codebook import f32_without_tf32
    from ..factory import build_train_model
    from ..training.state import make_optimizer
    from ..training.trainer import INIT_TAG, Trainer, derive_seed, global_losses
    from .distributed import is_primary

    mesh = make_mesh()
    ds = dryrun_dataset(cfg, device)
    trainer = Trainer(cfg, ds, seed=seed, mesh=mesh)
    primary = is_primary()
    ref = ref_opt = None
    if primary:
        ref = build_train_model(cfg, device, derive_seed(seed, INIT_TAG))
        ref_opt = make_optimizer(ref, cfg)
    group = mesh.get_group(DATA_AXIS)
    checks = []
    with f32_without_tf32():
        for s in range(steps):
            if primary:  # the one-process step from the Trainer's state, on the global batch
                ref.load_state_dict(trainer.model.state_dict())
                ref_opt.load_state_dict(trainer.optimizer.state_dict())
                gen = torch.Generator(device=device).manual_seed(derive_seed(seed, s))
                x, y = ds.sample_batch(gen, cfg.batch_size)
                ref.train()
                out = ref(x, y, train=True, generator=gen)
                ref_opt.zero_grad()
                out.total_loss.backward()
                ref_loss = float(out.total_loss.detach())
                ref_grads = {k: p.grad.clone() for k, p in ref.named_parameters()}
            losses = trainer.step_fn(trainer.generator_for(s))
            trainer.step = s + 1
            names = list(losses)
            vec = global_losses(torch.stack([losses[k].float() for k in names]), names, group)
            if primary:
                loss = float(vec[names.index("total_loss")])
                grads = {k: p.grad.clone() for k, p in trainer.model.named_parameters()}
                grad_rel = max(_max_rel(grads[k], g) for k, g in ref_grads.items())
                bufs = dict(trainer.model.named_buffers())
                stat_err = max([float((bufs[k] - b).abs().max()) for k, b in ref.named_buffers()
                                if b.is_floating_point()] or [0.0])
                for k, p in ref.named_parameters():  # the update given the Trainer's gradients
                    p.grad = grads[k]
                ref_opt.step()
                params = dict(trainer.model.named_parameters())
                update_err = max(float((params[k] - p).detach().abs().max()) for k, p in ref.named_parameters())
                checks.append({"loss": loss, "ref_loss": ref_loss, "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                               "grad_rel": grad_rel, "stat_err": stat_err, "update_err": update_err})
    _sync(device)
    state = {k: float(v.double().sum()) for k, v in trainer.model.state_dict().items() if v.is_floating_point()}
    out = {"checks": checks, "state_sums": state}
    if time_steps:
        out["ms_per_step"] = {"global": _time_steps(trainer, time_steps, device)}
        weak = Trainer(dataclasses.replace(cfg, batch_size=cfg.batch_size * axis_size(mesh, DATA_AXIS)), ds,
                       seed=seed, mesh=mesh)
        out["ms_per_step"]["per_rank"] = _time_steps(weak, time_steps, device)
    return out


def _time_steps(trainer, n: int, device) -> float:
    """Host ms a step over `n` steps after 3 warm-up steps, synchronized."""
    from ..codebook import f32_without_tf32
    from .distributed import barrier

    with f32_without_tf32():
        for s in range(3):
            trainer.step_fn(trainer.generator_for(1000 + s))
        _sync(device)
        barrier()
        t0 = time.perf_counter()
        for s in range(n):
            trainer.step_fn(trainer.generator_for(2000 + s))
        _sync(device)
        barrier()
    return 1e3 * (time.perf_counter() - t0) / n


def _kernel_wrappers():
    """The port's kernel wrappers, each counting its launches."""
    from ..ops import icp_nn, multi_codebook, nn_query

    return (multi_codebook.grouped_codebook_top1, multi_codebook.grouped_codebook_topk,
            nn_query.cosine_top1_cuda, icp_nn.batched_nn_cuda)


def query_rank(device, n_rows: int, d: int, b: int, k: int, dtype: str, seed: int, calls: int = 0) -> Dict:
    """One rank of the row-sharded queries: a seeded unit-row (n_rows, d)
    codebook in `dtype` (row 3 copied into the second shard's first rows'
    neighbourhood, so the copy lies in another shard), each rank holding its
    block of rows; top-1 (B3) and top-k (B2) through the sharded queries
    against the replicated kernels on the whole codebook. The launches of
    the sharded calls alone are counted; with `calls`, host ms a sharded
    call (synchronized, after a warm-up call)."""
    from ..ops._cuda import stream_width
    from ..ops.multi_codebook import grouped_codebook_topk
    from ..ops.nn_query import (cosine_top1_cuda, make_cosine_top1_sharded, make_cosine_topk_sharded,
                                pad_columns)

    mesh = make_mesh()
    w = axis_size(mesh, DATA_AXIS)
    rng = np.random.RandomState(seed)
    cb = rng.randn(n_rows, d).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=1, keepdims=True)
    dup = n_rows // w + 3 if w > 1 else 3
    cb[dup] = cb[3]  # a tie across shards: the lowest global index wins
    z = rng.randn(b, d).astype(np.float32)
    z[0] = cb[3]
    torch_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    full = pad_columns(torch.from_numpy(cb).to(device=device, dtype=torch_dtype),
                       stream_width(d, torch_dtype)).contiguous()
    block = codebook_sharding(mesh, full, shard_rows=True, axis=DATA_AXIS).contiguous()
    zt = torch.from_numpy(z).to(device)
    top1 = make_cosine_top1_sharded(mesh, axis=DATA_AXIS)
    topk = make_cosine_topk_sharded(mesh, k, axis=DATA_AXIS)
    wrappers = _kernel_wrappers()
    for fn in wrappers:
        fn.launches = 0
    v1, i1 = top1(zt, block)
    vk, ik = topk(zt, block)
    _sync(device)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    out = {"launches": launches, "block_rows": int(block.shape[0]), "dup": dup,
           "sharded": [t.cpu() for t in (v1, i1, vk, ik)]}
    out["replicated"] = [t.cpu() for t in (*cosine_top1_cuda(zt, full), *grouped_codebook_topk(zt, full[None], 0, n_rows, k=k))]
    # the replicated ranking's scores, for the margins: f32 products of the
    # queries cast to the codebook dtype (the kernels' formula)
    from ..ops.nn_query import l2_normalize

    q = pad_columns(l2_normalize(zt.float()).to(torch_dtype), full.shape[1]).float()
    out["scores"] = (q @ full.float().T).cpu()
    if calls:
        for fn in (top1, topk):
            fn(zt, block)
        ms = {}
        for name, fn in (("top1", top1), ("topk", topk)):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(calls):
                v, _ = fn(zt, block)
            v.cpu()
            ms[name] = 1e3 * (time.perf_counter() - t0) / calls
        out["host_ms_per_call"] = ms
    return out


def check_queries(results: List[Dict], k: int) -> Dict:
    """Hold the ranks' sharded results to the replicated kernel: the same
    on every rank; indices equal where the replicated ranking's margin
    exceeds MARGIN, values within VAL_TOL; the planted cross-shard tie
    returns the lower row. Returns the largest value error and tie count."""
    first = results[0]
    for r, res in enumerate(results[1:], 1):
        for a, b in zip(res["sharded"], first["sharded"]):
            if not torch.equal(a, b):
                raise AssertionError(f"rank {r}'s sharded result differs from rank 0's")
    v1, i1, vk, ik = first["sharded"]
    rv1, ri1, rvk, rik = first["replicated"]
    scores = first["scores"]
    srt = torch.sort(scores, dim=1, descending=True).values
    err = max(float((v1 - rv1).abs().max()), float((vk - rvk).abs().max()))
    if err > VAL_TOL:
        raise AssertionError(f"sharded values {err:.2e} off the replicated kernel's (> {VAL_TOL})")
    ties = 0
    for j in range(k):
        margin = torch.minimum(srt[:, j] - srt[:, j + 1], srt[:, j - 1] - srt[:, j]) if j else srt[:, 0] - srt[:, 1]
        ok = (ik[:, j] == rik[:, j]) | (margin <= MARGIN)
        ties += int((ik[:, j] != rik[:, j]).sum())
        if not bool(ok.all()):
            raise AssertionError(f"sharded top-k column {j}: {ik[:, j].tolist()} against {rik[:, j].tolist()}")
    ok1 = (i1 == ri1) | (srt[:, 0] - srt[:, 1] <= MARGIN)
    if not bool(ok1.all()):
        raise AssertionError(f"sharded top-1 {i1.tolist()} against {ri1.tolist()}")
    if int(i1[0]) != 3 or int(ik[0, 0]) != 3:
        raise AssertionError(f"the cross-shard tie (rows 3 and {first['dup']}) returned {int(i1[0])}, {int(ik[0, 0])}")
    return {"max_abs_err": err, "ties": ties + int((i1 != ri1).sum())}


def dryrun_rank(device, cfg, seed: int, steps: int, n_rows: int, b: int, k: int, time_steps: int = 0,
                query_calls: int = 0) -> Dict:
    """One rank of the whole dry run: `train_rank`, then `query_rank` on an
    f32 and a bf16 codebook."""
    return {"train": train_rank(device, cfg, seed, steps, time_steps),
            "queries": {dtype: query_rank(device, n_rows, cfg.latent_space_size, b, k, dtype, seed, query_calls)
                        for dtype in ("float32", "bfloat16")}}


def dryrun_multigpu(world: int, device: str, cfg=None, steps: int = 3, seed: int = 0,
                    n_rows: Optional[int] = None, time_steps: int = 0,
                    query_calls: int = 0, timeout: float = 900.0) -> Dict:
    """The multi-GPU dry run over `world` ranks on `device` ("cpu" or
    "cuda"), all of it in one spawn of the ranks; `cfg` defaults to
    `dryrun_config(world)`, the codebook to 64 rows a rank (at the cfg's
    latent width), queried by QUERIES latents at top-1 and top-K.
    Raises on any failed check; returns the summary: rank 0's per-step
    measurements, the queries' errors and launches summed over the ranks,
    the backend, and with `time_steps` / `query_calls` the host times."""
    cfg = cfg if cfg is not None else dryrun_config(world)
    if cfg.batch_size % world:
        raise ValueError(f"batch {cfg.batch_size} does not divide over {world} ranks")
    _, backend = rank_devices(world, device)
    got = run_ranks(dryrun_rank, world, device, cfg, seed, steps, n_rows or 64 * world, QUERIES, K, time_steps,
                    query_calls, timeout=timeout)

    train = [g["train"] for g in got]
    checks = train[0]["checks"]
    for s, c in enumerate(checks):
        if not (c["loss_rel"] <= LOSS_RTOL and c["grad_rel"] <= GRAD_RTOL and c["update_err"] <= UPDATE_TOL
                and c["stat_err"] <= STAT_TOL):
            raise AssertionError(f"step {s}: {world} ranks against one process: {c}")
    for r, res in enumerate(train[1:], 1):
        if res["state_sums"] != train[0]["state_sums"]:
            raise AssertionError(f"rank {r}'s parameters differ from rank 0's after {steps} steps")

    # weak scaling: the per-rank batch stays constant as the data axis grows
    per_rank = cfg.batch_size // world
    for m in sorted({max(1, world // 2), world}):
        sizes = {stop - start for start, stop in (shard_range(per_rank * m, i, m) for i in range(m))}
        if sizes != {per_rank}:
            raise AssertionError(f"weak scaling broken at {m} ranks: shard sizes {sizes}")

    summary = {"world": world, "device": device, "backend": backend, "steps": checks,
               "weak_scaling_per_rank": per_rank, "queries": {}}
    for dtype in got[0]["queries"]:
        res = [g["queries"][dtype] for g in got]
        summary["queries"][dtype] = {
            **check_queries(res, K),
            "launches": {name: sum(r["launches"][name] for r in res) for name in res[0]["launches"]},
            "host_ms_per_call": res[0].get("host_ms_per_call"),
        }
    if time_steps:
        summary["ms_per_step"] = train[0]["ms_per_step"]
    return summary
