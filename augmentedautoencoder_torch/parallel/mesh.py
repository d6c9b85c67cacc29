"""The (data, model) mesh and the shard layouts (port of augmentedautoencoder_tpu/parallel/mesh.py).

The layouts follow the JAX package's:

  * training: a 1-D data mesh. The model is replicated (DDP), the global
    batch is cut into one slice a rank, and the gradients are averaged
    over the data axis (training/trainer.py);
  * codebook build: each rank encodes its own views and the codes are
    gathered in view order (`Codebook.build_embedding`);
  * serving: codebook ROWS shard over an axis for object sets whose
    codebooks outgrow one card (`ops.nn_query.make_cosine_top1_sharded`,
    `make_cosine_topk_sharded`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the process
group; the layouts are plain helpers that return this rank's block of a
leading axis, where JAX places the array with a `NamedSharding`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .distributed import in_group

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: Optional[int] = None, model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over the process group's ranks (default: all on
    the data axis). Needs a process group (`parallel.initialize`); its
    device type is the backend's (NCCL: cuda, gloo: cpu; the mesh's groups
    carry either kind of tensor on gloo)."""
    if not in_group():
        raise RuntimeError("make_mesh needs a process group: call parallel.initialize() first")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"{data}x{model} mesh != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of shards along `axis`."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)


def shard_range(n: int, index: int, count: int) -> Tuple[int, int]:
    """Rows [start, stop) of shard `index` of `count` equal shards of n rows;
    ValueError when n does not divide by `count` (JAX's device_put raises
    for such a layout)."""
    if n % count:
        raise ValueError(f"a leading axis of {n} does not divide into {count} shards")
    m = n // count
    return index * m, (index + 1) * m


def shard(x, mesh: DeviceMesh, axis: str):
    """This rank's block of x's leading axis along `axis`."""
    start, stop = shard_range(x.shape[0], axis_index(mesh, axis), axis_size(mesh, axis))
    return x[start:stop]


def batch_sharding(mesh: DeviceMesh, x):
    """This rank's slice of a batch: the leading axis over the data axis."""
    return shard(x, mesh, DATA_AXIS)


def codebook_sharding(mesh: DeviceMesh, codebook, shard_rows: bool = False, axis: str = MODEL_AXIS):
    """The codebook as this rank holds it: whole by default; with
    `shard_rows`, its block of rows along `axis` (pair with
    ops.nn_query.make_cosine_top1_sharded / make_cosine_topk_sharded)."""
    return shard(codebook, mesh, axis) if shard_rows else codebook


def replicated(mesh: DeviceMesh, x):
    """x as every rank holds it: whole (JAX's replicated layout)."""
    return x
