"""The port's serving at latent widths that the CUDA kernels do not copy as
they are (100 and 102), against the JAX package and against the port's
own queries on unpadded operands.

`PoseServer` stores its slab, and `Codebook` its top-1 operand, with zero
columns up to `_cuda.stream_width` (f32: 100 stays 100, 102 -> 104; bf16:
-> 112); the queries are padded to match. Zero columns add exact zeros, so
the poses must not move: codebook indices equal, trafos within atol 1e-5
(the JAX comparison, as in test_torch_serving.py) or identical (the port
against itself).
"""

import os

import numpy as np
import pytest
import torch

from _torch_port_ws import TINY_CFG, make_frames, make_jax_workspace, write_test_cfg

torch.set_num_threads(1)

ATOL = 1e-5
CLASSES = {"cls_a": "obj_a", "cls_b": "obj_b"}


@pytest.fixture(scope="module", params=[100, 102], ids=["latent100", "latent102"])
def ws(request, tmp_path_factory):
    latent = request.param
    root = tmp_path_factory.mktemp(f"torch_width_{latent}")
    old = os.environ.get("AE_WORKSPACE_PATH")
    text = TINY_CFG.replace("LATENT_SPACE_SIZE: 16", f"LATENT_SPACE_SIZE: {latent}")
    make_jax_workspace(root / "workspace", {"obj_a": 3, "obj_b": 4}, cfg_text=text)
    yield root, latent
    if old is None:
        os.environ.pop("AE_WORKSPACE_PATH", None)
    else:
        os.environ["AE_WORKSPACE_PATH"] = old


@pytest.fixture(autouse=True)
def _workspace_env(ws, monkeypatch):
    monkeypatch.setenv("AE_WORKSPACE_PATH", str(ws[0] / "workspace"))


def _same(got, want, atol):
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.trafo, w.trafo, atol=atol, rtol=0)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("extra", ["", "topk_aggregate = 8\n"], ids=["top1", "agg8"])
def test_pose_server_serves_the_unpadded_poses(ws, precision, extra):
    from augmentedautoencoder_torch.ops import _cuda
    from augmentedautoencoder_torch.serving import PoseServer

    root, latent = ws
    cfg_path = write_test_cfg(root / f"srv_{precision}_{len(extra)}.cfg", CLASSES, extra)
    server = PoseServer(cfg_path, max_dets_per_class=4, precision=precision, device="cpu")
    dtype = server._slab.dtype
    assert server._slab.shape[-1] == _cuda.stream_width(latent, dtype)
    assert not server._slab[..., latent:].any()
    unpadded = PoseServer(cfg_path, max_dets_per_class=4, precision=precision, device="cpu")
    unpadded._slab = unpadded._slab[..., :latent].contiguous()
    frames = make_frames(list(CLASSES), n_frames=2, dets_per_class=3, seed=latent + len(extra))
    for fr in frames:
        _same(server.process(**fr), unpadded.process(**fr), atol=0)
    if precision == "float32":
        from augmentedautoencoder_tpu.serving import PoseServer as JaxServer

        jserver = JaxServer(cfg_path, max_dets_per_class=4)
        for fr in frames:
            _same(server.process(**fr), jserver.process(**fr), atol=ATOL)


def test_estimator_codebook_serves_the_jax_poses(ws):
    """AePoseEstimator's f32 top-1 runs Codebook's padded top-1 operand;
    the JAX estimator serves the same poses on the unpadded codebook."""
    from augmentedautoencoder_tpu.pose import AePoseEstimator as JaxEstimator
    from augmentedautoencoder_torch.ops import _cuda
    from augmentedautoencoder_torch.pose import AePoseEstimator

    root, latent = ws
    cfg_path = write_test_cfg(root / "est.cfg", CLASSES)
    est, jest = AePoseEstimator(cfg_path, device="cpu"), JaxEstimator(cfg_path)
    for cb in est.all_codebooks.values():
        assert cb.embedding_normalized.shape[-1] == latent
        assert cb._top1_operand.shape[-1] == _cuda.stream_width(latent, torch.float32)
        assert torch.equal(cb._top1_operand[:, :latent], cb.embedding_normalized)
        assert not cb._top1_operand[:, latent:].any()
        assert (cb._top1_operand is cb.embedding_normalized) == (latent % 4 == 0)
    for fr in make_frames(list(CLASSES), n_frames=2, dets_per_class=3, seed=latent):
        _same(est.process(**fr), jest.process(**fr), atol=ATOL)
