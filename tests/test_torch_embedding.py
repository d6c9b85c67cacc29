"""The port's codebook build (Codebook.build_embedding, cli/ae_embed,
CheckpointManager.add_codebook) against the JAX package's at a tiny width:
48 views (MIN_N_VIEWS 12 x NUM_CYCLO 4) in batches of 20, so the last batch
is a ragged tail of 8. Rows agree within 1e-5 (cuDNN-free CPU convolutions
in both, summed in different orders) and the top-1 of every row is equal.

The JAX `Dataset` is always given a `Renderer` built here, once: its own
lazily built renderer is raced by its render threads."""

import numpy as np
import pytest
import torch

from augmentedautoencoder_tpu import factory as jax_factory
from augmentedautoencoder_tpu.codebook import Codebook as JaxCodebook
from augmentedautoencoder_tpu.renderer import Renderer as JaxRenderer
from augmentedautoencoder_torch import factory
from augmentedautoencoder_torch.cli import ae_embed
from augmentedautoencoder_torch.codebook import Codebook
from augmentedautoencoder_torch.training.checkpoint import CheckpointManager

from _torch_port_ws import dsprites_cfg, make_jax_workspace, write_dsprites_npz, write_procedural_mesh

torch.set_num_threads(2)
ATOL = 1e-5
BATCH = 20


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """One experiment with Flax params, converted to the port's checkpoint,
    rendering a procedural mesh; and the JAX dataset with its renderer."""
    root = tmp_path_factory.mktemp("torch_embedding")
    ply = write_procedural_mesh(root / "obj.ply")
    make_jax_workspace(root / "ws", {"obj": 3}, model_path=ply)
    cfg, paths, model, payload = jax_factory.restore_experiment("obj", "", None)
    renderer = JaxRenderer([cfg.model_path], samples=cfg.antialiasing,
                           vertex_tmp_store_folder=paths["dataset_path"], vertex_scale=cfg.vertex_scale,
                           backend="native")
    dataset = jax_factory.build_dataset(paths["dataset_path"], cfg, renderer=renderer)
    renders = dataset.render_embedding_image_batch(0, dataset.embedding_size)
    jax_emb, jax_bbs = JaxCodebook.build_embedding(
        jax_factory.make_encode_fn(model, payload["params"]), dataset.render_embedding_image_batch,
        dataset.embedding_size, BATCH, progress=False)
    return {"root": root, "paths": paths, "renders": renders, "jax_emb": jax_emb, "jax_bbs": jax_bbs,
            "jax_dataset": dataset}


def _top1(emb, queries):
    return np.argmax(queries @ emb.T, axis=1)


def test_ragged_tail_and_normalization():
    """Port of tests/test_codebook_build.py: every encode sees the full
    padded batch, the tail is covered once, rows are the sources' codes
    normalized."""
    n_total, batch, latent = 37, 16, 8
    rng = np.random.RandomState(0)
    source = rng.rand(n_total, 4, 4, 3).astype(np.float32)
    calls = []

    def render_batch(a, e):
        calls.append((a, e))
        return source[a:e], rng.randint(0, 50, (e - a, 4))

    def encode(xb):
        assert xb.shape[0] == batch
        return xb.reshape(xb.shape[0], -1)[:, :latent] + 0.1

    emb, bbs = Codebook.build_embedding(encode, render_batch, n_total, batch, progress=False, device="cpu")
    assert emb.shape == (n_total, latent) and emb.dtype == np.float32
    assert bbs.shape == (n_total, 4)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
    assert calls == [(0, 16), (16, 32), (32, 37)]
    raw = source.reshape(n_total, -1)[:, :latent] + 0.1
    raw /= np.linalg.norm(raw, axis=1, keepdims=True)
    np.testing.assert_allclose(emb, raw, rtol=1e-5)


def test_uint8_batches_reach_the_encoder_as_uint8_padded_with_zeros():
    """uint8 renders are uploaded as they are (make_encode_fn normalizes
    them on the device); the ragged tail is padded with zero images."""
    seen = []

    def encode(xb):
        seen.append(xb.clone())
        return xb.reshape(xb.shape[0], -1)[:, :4] + 0.5

    src = np.random.RandomState(1).randint(0, 256, (5, 2, 2, 3)).astype(np.uint8)
    emb, _ = Codebook.build_embedding(encode, lambda a, e: (src[a:e], np.zeros((e - a, 4))), 5, 4,
                                      progress=False, device="cpu")
    assert [x.dtype for x in seen] == [torch.uint8, torch.uint8]
    np.testing.assert_array_equal(seen[1][:1].numpy(), src[4:])
    assert not seen[1][1:].any()  # the ragged tail padded with zeros


def test_empty_embedding_raises_clear_error():
    with pytest.raises(ValueError, match="no view batches"):
        Codebook.build_embedding(lambda xb: xb, lambda a, e: (None, None), 0, 16, progress=False,
                                 device="cpu")


def test_build_embedding_needs_cuda_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the refusal is what a CPU-only host sees")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Codebook.build_embedding(lambda xb: xb, lambda a, e: (None, None), 4, 4, progress=False)


def test_build_embedding_matches_jax_on_the_same_renders(ws):
    x, bbs = ws["renders"]
    cfg, _, model, _ = factory.restore_experiment("obj", device="cpu", precision="float32")
    prof = {}
    emb, got_bbs = Codebook.build_embedding(factory.make_encode_fn(model), lambda a, e: (x[a:e], bbs[a:e]),
                                            len(x), BATCH, progress=False, device="cpu", profile=prof)
    want = ws["jax_emb"]
    assert emb.shape == want.shape == (48, 16) and emb.dtype == np.float32
    np.testing.assert_allclose(emb, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(_top1(emb, want), _top1(want, want))
    np.testing.assert_array_equal(got_bbs, ws["jax_bbs"])
    assert prof["batches"] == 3 and prof["views"] == 48
    assert set(prof) >= {"render", "wait", "h2d", "encode", "readback", "total"}


def test_ae_embed_writes_a_codebook_the_port_serves(ws):
    """The CLI on the CPU: the checkpoint holds the JAX embedding within
    1e-5 (f32) and its boxes (int32), build_codebook_from_name serves it,
    and re-rendered views come back to their own rows."""
    path = ae_embed.main(["obj", "--batch_size", str(BATCH)], device="cpu")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    emb, bbs = payload["embedding_normalized"], payload["embed_obj_bbs"]
    assert emb.dtype == torch.float32 and bbs.dtype == torch.int32 and payload["step"] == 10
    np.testing.assert_allclose(emb.numpy(), ws["jax_emb"], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(bbs.numpy(), ws["jax_bbs"].astype(np.int32))
    cb = factory.build_codebook_from_name("obj", device="cpu")
    assert torch.equal(cb.embedding_normalized, emb)
    np.testing.assert_array_equal(cb.embed_obj_bbs, bbs.numpy())
    x, _ = ws["renders"]
    idcs = cb.nearest_rotation(x[[0, 5, 22, 47]], return_idcs=True)
    want = _top1(ws["jax_emb"], ws["jax_emb"][[0, 5, 22, 47]])
    np.testing.assert_array_equal(idcs, want)
    # the default batch is max(BATCH_SIZE, 256): one padded batch of 48
    prof = {}
    ae_embed.main(["obj"], device="cpu", profile=prof)
    assert prof["batches"] == 1


def test_ae_embed_needs_cuda_unless_given_the_cpu(ws):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the refusal is what a CPU-only host sees")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ae_embed.main(["obj"])


def test_ae_embed_refuses_dsprites_until_training_is_ported(tmp_path, monkeypatch):
    """MODEL dsprites, refused until the dsprites path was ported, now
    embeds its orientation codebook: the port's ae_embed against the JAX
    ae_embed on the same (converted) parameters, 40 unit rows within 1e-5,
    re-saved into the checkpoint without boxes."""
    import sys

    from augmentedautoencoder_tpu.cli import ae_embed as jax_ae_embed
    from augmentedautoencoder_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
    from augmentedautoencoder_torch import workspace

    npz = write_dsprites_npz(tmp_path / "dsprites.npz")
    root = tmp_path / "ws"
    monkeypatch.setenv(workspace.WORKSPACE_ENV_VAR, str(root))  # restored after the test
    make_jax_workspace(root, {"sprites": 5}, model_path=npz, cfg_text=dsprites_cfg(npz))
    paths = factory.experiment_paths("sprites")
    monkeypatch.setattr(sys, "argv", ["ae_embed", "sprites"])
    jax_ae_embed.main()
    want = np.asarray(JaxCheckpointManager(paths["checkpoint_dir"]).restore()["embedding_normalized"])
    path = ae_embed.main(["sprites"], device="cpu")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    emb = payload["embedding_normalized"].numpy()
    assert emb.shape == want.shape == (40, 8) and emb.dtype == np.float32 and payload["step"] == 10
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(emb, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(_top1(emb, emb), np.arange(40))


def test_add_codebook_re_saves_the_checkpoint(tmp_path):
    """As the JAX CheckpointManager.add_codebook: the given (or newest)
    step, f32 embedding, int32 boxes; without boxes the old ones stay; no
    checkpoint raises."""
    from augmentedautoencoder_torch.models import AAE

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(FileNotFoundError):
        mgr.add_codebook(np.zeros((3, 4)), None)
    torch.manual_seed(0)
    model = AAE(input_shape=(16, 16, 3), latent_space_size=4, num_filters=(4,), strides=(2,))
    mgr.save(5, model.state_dict())
    mgr.save(12, model.state_dict(), np.ones((3, 4)), np.full((3, 4), 7))
    emb = np.random.RandomState(0).rand(3, 4)
    path = mgr.add_codebook(emb, np.array([[1.9, 2, 3, 4]] * 3), step=5)
    p5 = mgr.restore(5)
    assert path == mgr.path_for_step(5) and p5["step"] == 5
    assert p5["embedding_normalized"].dtype == torch.float32
    np.testing.assert_array_equal(p5["embedding_normalized"].numpy(), emb.astype(np.float32))
    assert p5["embed_obj_bbs"].dtype == torch.int32 and p5["embed_obj_bbs"][0].tolist() == [1, 2, 3, 4]
    for k, v in model.state_dict().items():
        assert torch.equal(p5["state_dict"][k], v)
    mgr.add_codebook(emb, None)  # newest step: 12 keeps its boxes
    p12 = mgr.restore()
    assert p12["step"] == 12 and p12["embed_obj_bbs"].tolist() == [[7] * 4] * 3
    np.testing.assert_array_equal(p12["embedding_normalized"].numpy(), emb.astype(np.float32))
