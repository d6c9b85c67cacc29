"""Rank functions of the multi-rank tests, run by
`augmentedautoencoder_torch.parallel.dryrun.run_ranks` in spawned processes
joined over gloo on the CPU. This module imports torch and the port only:
each rank imports it afresh, and never needs jax."""

import functools
import os

import numpy as np
import torch

from augmentedautoencoder_torch import parallel
from augmentedautoencoder_torch.parallel import mesh as pmesh


def semantics(device):
    """What one rank sees of `parallel`: the group, the primary rank, the
    broadcast, the mesh and its layouts."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "world": world, "backend": dist.get_backend(), "again": parallel.initialize(),
           "primary": parallel.is_primary(), "world_size": parallel.world_size()}
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(rank + 1.0)
        module.bias.fill_(-rank)
    tensors = {"a": torch.full((4,), float(rank)), "b": torch.arange(3) * (rank + 1)}
    parallel.host_replicate(module)
    parallel.host_replicate(tensors)
    out["module"] = [module.weight.clone(), module.bias.clone()]
    out["tensors"] = tensors
    mesh = parallel.make_mesh()
    x = torch.arange(4 * world * 2).view(4 * world, 2)
    out["mesh"] = {"dims": mesh.mesh_dim_names, "data": parallel.axis_size(mesh, "data"),
                   "model": parallel.axis_size(mesh, "model"), "index": parallel.axis_index(mesh, "data"),
                   "batch": parallel.batch_sharding(mesh, x), "replicated": parallel.replicated(mesh, x),
                   "rows_model": parallel.codebook_sharding(mesh, x, shard_rows=True),
                   "rows_data": parallel.codebook_sharding(mesh, x, shard_rows=True, axis="data"),
                   "whole": parallel.codebook_sharding(mesh, x)}
    model_mesh = parallel.make_mesh(data=1, model=world)
    out["model_mesh"] = {"data": parallel.axis_size(model_mesh, "data"),
                         "model": parallel.axis_size(model_mesh, "model"),
                         "rows": parallel.codebook_sharding(model_mesh, x, shard_rows=True)}
    errors = {}
    for name, call in (("mesh", lambda: parallel.make_mesh(data=world + 1)),
                       ("batch", lambda: parallel.batch_sharding(mesh, x[:-1])),
                       ("rows", lambda: parallel.codebook_sharding(model_mesh, x[:-1], shard_rows=True))):
        try:
            call()
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    # the differentiable sum: each rank's input gets every rank's output gradient
    from augmentedautoencoder_torch.parallel.distributed import all_reduce_sum

    v = torch.full((3,), rank + 1.0, requires_grad=True)
    s = all_reduce_sum(v * 1.0)
    (s * (rank + 1)).sum().backward()
    out["sum"], out["sum_grad"] = s.detach(), v.grad
    return out


def checkpoint_write(device, ckpt_dir):
    """Each rank tries to write a checkpoint: (path written or the error)."""
    from augmentedautoencoder_torch.training.checkpoint import CheckpointManager

    try:
        return CheckpointManager(ckpt_dir).save(1, {"w": torch.zeros(2)})
    except RuntimeError as e:
        return f"refused: {e}"


def step_from_state(device, cfg, state_dict, opt_state, x, y, noise):
    """One data-parallel train step of the global batch (x, y) from a given
    model and optimizer state: this rank composes nothing and takes its
    rows of x, y and the VAE noise, as the JAX step's data mesh shards them.
    Returns the global losses (rank 0) and the state after the step."""
    from augmentedautoencoder_torch.models import AAE
    from augmentedautoencoder_torch.training import make_optimizer
    from augmentedautoencoder_torch.training.trainer import data_parallel, global_losses

    mesh = parallel.make_mesh()
    model = AAE.from_config(cfg, train=True)
    model.load_state_dict(state_dict)
    opt = make_optimizer(model, cfg)
    opt.load_state_dict(opt_state)
    ddp = data_parallel(model, mesh)
    start, stop = pmesh.shard_range(x.shape[0], parallel.axis_index(mesh, "data"), parallel.axis_size(mesh, "data"))
    rows = slice(start, stop)
    ddp.train()
    out = ddp(torch.from_numpy(x[rows]), torch.from_numpy(y[rows]), train=True,
              noise=None if noise is None else torch.from_numpy(noise[rows]))
    opt.zero_grad()
    out.total_loss.backward()
    opt.step()
    names = list(out.losses)
    vec = global_losses(torch.stack([out.losses[k].detach().float() for k in names]), names,
                        mesh.get_group("data"))
    return {"losses": dict(zip(names, vec.tolist())), "state": model.state_dict(), "count": int(opt.count)}


def train_cli(device, argv):
    """`cli.ae_train.main` on this rank (summaries without tensorboard):
    the step reached, the state, the checkpoints this rank tried to write."""
    from augmentedautoencoder_torch.cli import ae_train
    from augmentedautoencoder_torch.training.metrics import MetricWriter

    ae_train.MetricWriter = functools.partial(MetricWriter, use_tensorboard=False)
    trainer = ae_train.main(argv, device=device)
    return {"step": trainer.step, "state": trainer.model.state_dict()}


def sharded_query(device, cb, z, k, axis, model_axis_size=1):
    """The row-sharded top-1 and top-k (k) of queries z against codebook
    cb (numpy, f32 or a torch bf16 tensor), each rank holding its rows
    along `axis` at the kernels' stored width."""
    from augmentedautoencoder_torch.ops._cuda import stream_width
    from augmentedautoencoder_torch.ops.nn_query import (make_cosine_top1_sharded, make_cosine_topk_sharded,
                                                         pad_columns)

    mesh = parallel.make_mesh(model=model_axis_size)
    full = torch.as_tensor(cb)
    full = pad_columns(full, stream_width(full.shape[1], full.dtype))
    block = parallel.codebook_sharding(mesh, full, shard_rows=True, axis=axis).contiguous()
    zt = torch.from_numpy(z)
    v1, i1 = make_cosine_top1_sharded(mesh, axis=axis)(zt, block)
    vk, ik = make_cosine_topk_sharded(mesh, k, axis=axis)(zt, block)
    return {"block_rows": block.shape[0], "top1": (v1, i1), "topk": (vk, ik)}


def sharded_rows_error(device, n_rows):
    """The error of sharding n_rows codebook rows over the data axis."""
    mesh = parallel.make_mesh()
    try:
        parallel.codebook_sharding(mesh, torch.zeros(n_rows, 16), shard_rows=True, axis="data")
    except ValueError as e:
        return str(e)
    return None


def embed_cli(device, argv):
    """`cli.ae_embed.main` on this rank: the checkpoint path it returns."""
    from augmentedautoencoder_torch.cli import ae_embed

    return ae_embed.main(argv, device=device)


def encode_sharded(device, cfg, state_dict, x):
    """`factory.make_encode_fn(model, mesh)` on the global batch x."""
    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch.models import AAE

    model = AAE.from_config(cfg, precision="float32")
    model.load_state_dict(state_dict)
    model.eval()
    return factory.make_encode_fn(model, parallel.make_mesh())(torch.from_numpy(x))


def build_embedding_ranks(device, n, batch):
    """Codebook.build_embedding over the data axis with a recording render
    function: the rows and the view batches this rank rendered."""
    from augmentedautoencoder_torch.codebook import Codebook

    rng = np.random.RandomState(0)
    source = rng.rand(n, 4, 4, 3).astype(np.float32)
    boxes = rng.randint(0, 50, (n, 4)).astype(np.float64)
    calls = []

    def render(a, e):
        calls.append((a, e))
        return source[a:e], boxes[a:e]

    emb, bbs = Codebook.build_embedding(lambda xb: xb.reshape(xb.shape[0], -1)[:, :8] + 0.1, render, n, batch,
                                        progress=False, device=device, mesh=parallel.make_mesh())
    return {"emb": emb, "bbs": bbs, "calls": calls, "pid": os.getpid()}
