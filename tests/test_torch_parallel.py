"""The port's multi-process layer (augmentedautoencoder_torch/parallel/)
against the JAX package's `parallel` semantics: `initialize` (a single
process starts nothing; the world from the arguments, AAE_NUM_PROCESSES or
torchrun's variables; gloo for CPU ranks; no CPU fallback without CUDA),
`is_primary`, `host_replicate`, `make_mesh` (its data x model assertion)
and the shard layouts (an indivisible axis raises, as JAX's device_put
does), and `factory.default_device` inside a group. Ranks are spawned
processes joined over gloo through a `file://` rendezvous."""

import os

import numpy as np
import pytest
import torch

from augmentedautoencoder_torch import factory, parallel
from augmentedautoencoder_torch.parallel import distributed
from augmentedautoencoder_torch.parallel.dryrun import run_ranks
from augmentedautoencoder_torch.parallel.mesh import shard_range

import _torch_ddp_ranks as ranks

_WORLD_VARS = ("AAE_NUM_PROCESSES", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def no_world(monkeypatch):
    for name in _WORLD_VARS:
        monkeypatch.delenv(name, raising=False)


def test_single_process_starts_nothing(no_world):
    assert parallel.initialize() is False
    assert parallel.initialize(num_processes=1, device="cpu") is False
    assert not distributed.in_group()
    assert parallel.is_primary() and parallel.world_size() == 1
    parallel.barrier()  # returns at once
    t = torch.ones(3)
    assert parallel.host_replicate(t) is t


def test_initialize_refuses_cuda_without_a_card(no_world, monkeypatch):
    """Two processes asked for on CUDA without a card: the rank raises
    before it joins any group (nothing falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("AAE_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        parallel.initialize()
    assert not distributed.in_group()


def test_make_mesh_needs_a_group(no_world):
    with pytest.raises(RuntimeError, match="initialize"):
        parallel.make_mesh()


def test_default_device_is_the_ranks_card(monkeypatch):
    """Inside a group the entry points' device is cuda:LOCAL_RANK; outside
    one `cuda`; without CUDA it raises either way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert factory.default_device() == torch.device("cuda")
    monkeypatch.setattr(factory, "in_group", lambda: True)
    assert factory.default_device() == torch.device("cuda", 3)
    assert distributed.rank_device("cuda") == torch.device("cuda", 3)
    assert distributed.rank_device("cuda:1") == torch.device("cuda", 1)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        factory.default_device()


@pytest.mark.parametrize("n,count", [(8, 2), (12, 4), (7, 1)])
def test_shard_range_cuts_equal_blocks(n, count):
    blocks = [shard_range(n, i, count) for i in range(count)]
    assert blocks[0][0] == 0 and blocks[-1][1] == n
    assert all(b - a == n // count for a, b in blocks)
    assert all(blocks[i][1] == blocks[i + 1][0] for i in range(count - 1))


def test_shard_range_refuses_an_indivisible_axis():
    with pytest.raises(ValueError, match="does not divide"):
        shard_range(10, 0, 4)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_see_one_group_mesh_and_layouts(world):
    got = run_ranks(ranks.semantics, world, "cpu")
    x = torch.arange(4 * world * 2).view(4 * world, 2)
    for r, out in enumerate(got):
        assert (out["rank"], out["world"], out["world_size"]) == (r, world, world)
        assert out["backend"] == "gloo" and out["again"] is True
        assert out["primary"] == (r == 0)
        # rank 0's values broadcast into every rank's module and tensors
        assert torch.equal(out["module"][0], torch.ones(2, 3)) and torch.equal(out["module"][1], torch.zeros(2))
        assert torch.equal(out["tensors"]["a"], torch.zeros(4)) and torch.equal(out["tensors"]["b"], torch.arange(3))
        m = out["mesh"]
        assert m["dims"] == ("data", "model") and (m["data"], m["model"], m["index"]) == (world, 1, r)
        assert torch.equal(m["batch"], x[4 * r:4 * (r + 1)]) and torch.equal(m["rows_data"], m["batch"])
        assert torch.equal(m["replicated"], x) and torch.equal(m["whole"], x)
        assert torch.equal(m["rows_model"], x)  # one shard on the model axis
        mm = out["model_mesh"]
        assert (mm["data"], mm["model"]) == (1, world) and torch.equal(mm["rows"], x[4 * r:4 * (r + 1)])
        assert set(out["errors"]) == {"mesh", "batch", "rows"}
        assert f"{world + 1}x1 mesh != {world} ranks" in out["errors"]["mesh"]
        assert "does not divide" in out["errors"]["batch"] and "does not divide" in out["errors"]["rows"]
        # the sum of 1..W, and the gradient of sum_r (r + 1) * sum: 1 + ... + W
        total = world * (world + 1) / 2
        np.testing.assert_array_equal(out["sum"].numpy(), np.full(3, total))
        np.testing.assert_array_equal(out["sum_grad"].numpy(), np.full(3, total))


def test_only_the_primary_rank_writes_checkpoints(tmp_path):
    got = run_ranks(ranks.checkpoint_write, 2, "cpu", str(tmp_path))
    assert got[0] == os.path.join(str(tmp_path), "chkpt-1.pt") and os.path.exists(got[0])
    assert got[1] == "refused: only the primary rank writes checkpoints"


def _env_rank(rank, init, out_dir):
    """A process that finds its world in the environment, as under torchrun."""
    os.environ.update({"AAE_NUM_PROCESSES": "2", "RANK": str(rank)})
    os.environ.pop("WORLD_SIZE", None)
    started = parallel.initialize(coordinator_address=init, device="cpu")
    import torch.distributed as dist

    with open(os.path.join(out_dir, f"{rank}.txt"), "w") as fh:
        fh.write(f"{started} {dist.get_rank()} {dist.get_world_size()} {dist.get_backend()}")
    parallel.shutdown()


def test_initialize_reads_the_world_from_the_environment(tmp_path):
    import torch.multiprocessing as mp

    mp.start_processes(_env_rank, args=(f"file://{tmp_path / 'rendezvous'}", str(tmp_path)), nprocs=2,
                       start_method="spawn", join=True)
    for r in range(2):
        assert (tmp_path / f"{r}.txt").read_text() == f"True {r} 2 gloo"
