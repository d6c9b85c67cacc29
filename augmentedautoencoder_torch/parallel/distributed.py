"""The multi-process runtime (port of augmentedautoencoder_tpu/parallel/distributed.py).

One process per card, started by `torchrun --nproc_per_node=N` (or given
its world, rank and coordinator explicitly): `initialize()` joins the
process group, NCCL for ranks on CUDA and gloo for ranks on the CPU, and
pins the rank to its card, `cuda:LOCAL_RANK`. Without a process group every
helper here is the single-process identity: `is_primary()` is True,
`barrier()` returns, `host_replicate` hands its argument back.

The collectives the port's multi-rank code uses live here too: an
autograd-aware all-reduce (BatchNorm's global statistics) and an all-gather
of equal row blocks in rank order (codes, query candidates).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist
from torch import nn

#: the world size the JAX package reads (`jax.distributed.initialize`)
NUM_PROCESSES_ENV = "AAE_NUM_PROCESSES"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name, "")
    return int(value) if value else None


def in_group() -> bool:
    """True inside an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """This rank's card on its host: torchrun's LOCAL_RANK (0 without it)."""
    return _env_int("LOCAL_RANK") or 0


def rank_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device of this rank: `device` if it names one (an index, or the
    CPU), else `cuda:LOCAL_RANK`. Raises without CUDA unless the CPU is
    asked for: nothing falls back to the CPU."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "augmentedautoencoder_torch runs on a CUDA device and none is available; "
                'pass device="cpu" to run on the CPU'
            )
        if dev.index is None:
            dev = torch.device("cuda", local_rank())
    return dev


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group; True when this process runs in one (also
    when it already did), False for a single process.

    The world size comes from `num_processes`, else AAE_NUM_PROCESSES, else
    torchrun's WORLD_SIZE; the rank from `process_id`, else RANK. With one
    process and no `coordinator_address` nothing is started. The coordinator
    is an init method (`file://...`, `tcp://host:port`) or a bare
    `host:port`; without one torchrun's MASTER_ADDR / MASTER_PORT are read
    (`env://`).

    The backend follows the rank's device (`rank_device(device)`): NCCL on
    CUDA, gloo on the CPU. `backend` overrides that choice explicitly, as
    for two ranks that share one card (NCCL refuses two ranks on one
    device; gloo takes CUDA tensors for all-reduce, broadcast and
    all-gather). A CUDA rank is pinned to its card first; NCCL's
    communicator is created here, so a failed NCCL init raises here."""
    if in_group():
        return True
    world = num_processes or _env_int(NUM_PROCESSES_ENV) or _env_int("WORLD_SIZE") or 1
    if world <= 1 and coordinator_address is None:
        return False
    rank = process_id if process_id is not None else (_env_int("RANK") or 0)
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        device_id=dev if backend == "nccl" else None,
    )
    return True


def shutdown() -> None:
    """Leave the process group (no-op outside one)."""
    if in_group():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that writes checkpoints, caches and logs: rank 0,
    or the only process."""
    return not in_group() or dist.get_rank() == 0


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


def barrier() -> None:
    """Wait for every rank (returns at once outside a group)."""
    if in_group():
        dist.barrier()


def host_replicate(module_or_tensors):
    """Broadcast rank 0's values into every rank's `module_or_tensors` in
    place: a module's parameters and buffers, or a tensor, or a dict / list
    / tuple of tensors. Returns its argument. Outside a group it is the
    identity."""
    if not in_group():
        return module_or_tensors
    obj = module_or_tensors
    if isinstance(obj, nn.Module):
        tensors = list(obj.parameters()) + list(obj.buffers())
    elif isinstance(obj, dict):
        tensors = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        tensors = list(obj)
    else:
        tensors = [obj]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    return module_or_tensors


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the gradient of every rank's input is the
    sum of the ranks' output gradients (each rank's loss depends on every
    rank's input through the sum)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the group's ranks, differentiable."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' equal (n, ...) blocks stacked in rank order: (W * n, ...)."""
    x = x.contiguous()
    blocks = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(blocks, x, group=group)
    return torch.cat(blocks)
