"""The codebook build over ranks (`Codebook.build_embedding(mesh=...)`,
cli/ae_embed under a process group) against the one-process build, and the
port's sharded encode (`factory.make_encode_fn(model, mesh)`) against the
JAX package's `make_encode_fn(mesh=...)`, on the CPU over gloo: each rank
renders and encodes its own contiguous run of the view batches, the rows
gathered in view order equal the one-process rows within 1e-6 and the boxes
exactly; the sharded codes are within 1e-5 of JAX's (tests/test_training.py's
bound for its sharded encode)."""

import jax
import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu import factory as jax_factory
from augmentedautoencoder_tpu import workspace as jax_ws
from augmentedautoencoder_tpu.parallel import make_mesh as jax_make_mesh
from augmentedautoencoder_torch import factory
from augmentedautoencoder_torch.cli import ae_embed
from augmentedautoencoder_torch.parallel.dryrun import run_ranks

import _torch_ddp_ranks as ranks
from _torch_port_ws import make_jax_workspace, write_procedural_mesh

torch.set_num_threads(2)
ROW_ATOL = 1e-6
CODE_ATOL = 1e-5


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """One experiment (48 views, latent 16) with Flax params converted to
    the port's checkpoint, rendering a procedural mesh."""
    root = tmp_path_factory.mktemp("torch_ddp_embed")
    ply = write_procedural_mesh(root / "obj.ply")
    return make_jax_workspace(root / "ws", {"obj": 3}, model_path=ply)


def _codebook(path):
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["embedding_normalized"].numpy(), payload["embed_obj_bbs"].numpy()


@pytest.mark.parametrize("world", [2, 3])
def test_ae_embed_over_ranks_equals_one_process(ws, monkeypatch, world):
    """48 views in batches of 20: 3 batches, a ragged tail of 8; the ranks
    take runs of [2, 1] or [1, 1, 1] batches."""
    monkeypatch.setenv(jax_ws.WORKSPACE_ENV_VAR, ws)
    want_emb, want_bbs = _codebook(ae_embed.main(["obj", "--batch_size", "20"], device="cpu"))
    paths = run_ranks(ranks.embed_cli, world, "cpu", ["obj", "--batch_size", "20"])
    assert len(set(paths)) == 1
    emb, bbs = _codebook(paths[0])
    assert emb.shape == want_emb.shape == (48, 16) and emb.dtype == np.float32
    np.testing.assert_allclose(emb, want_emb, atol=ROW_ATOL, rtol=0)
    np.testing.assert_array_equal(bbs, want_bbs)


@pytest.mark.parametrize("world", [2, 3])
def test_each_rank_renders_its_own_run_of_batches(world):
    """37 views in batches of 8 (5 batches, a tail of 5): rank r renders the
    r-th contiguous run and nothing else; every rank returns the one-process
    rows and boxes."""
    from augmentedautoencoder_torch.codebook import Codebook

    got = run_ranks(ranks.build_embedding_ranks, world, "cpu", 37, 8)
    spans = [(a, min(a + 8, 37)) for a in range(0, 37, 8)]
    runs = [[spans[i] for i in part] for part in np.array_split(np.arange(len(spans)), world)]
    assert [g["calls"] for g in got] == runs
    rng = np.random.RandomState(0)
    source, boxes = rng.rand(37, 4, 4, 3).astype(np.float32), rng.randint(0, 50, (37, 4)).astype(np.float64)
    want, want_bbs = Codebook.build_embedding(lambda xb: xb.reshape(xb.shape[0], -1)[:, :8] + 0.1,
                                              lambda a, e: (source[a:e], boxes[a:e]), 37, 8, progress=False,
                                              device="cpu")
    for g in got:
        np.testing.assert_array_equal(g["emb"], want)
        np.testing.assert_array_equal(g["bbs"], want_bbs)


def test_fewer_batches_than_ranks_raise():
    with pytest.raises(Exception, match="2 view batches do not spread over 3 data ranks"):
        run_ranks(ranks.build_embedding_ranks, 3, "cpu", 16, 8)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_encode_matches_jax(ws, monkeypatch, world):
    monkeypatch.setenv(jax_ws.WORKSPACE_ENV_VAR, ws)
    jcfg, _, jmodel, payload = jax_factory.restore_experiment("obj", "", None)
    x = np.random.RandomState(world).rand(8, 32, 32, 3).astype(np.float32)
    want = np.asarray(jax_factory.make_encode_fn(jmodel, payload["params"],
                                                 mesh=jax_make_mesh(jax.devices()[:world]))(x))
    cfg, _, model, _ = factory.restore_experiment("obj", device="cpu", precision="float32")
    got = run_ranks(ranks.encode_sharded, world, "cpu", cfg, model.state_dict(), x)
    for g in got:
        assert g.shape == (8, 16)
        np.testing.assert_allclose(g.numpy(), want, atol=CODE_ATOL, rtol=0)
