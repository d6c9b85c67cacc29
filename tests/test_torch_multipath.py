"""The multi-path model of the port (a MODEL_PATH of n_o meshes: the shared
encoder and a `DecoderBank` of one decoder an object) on the CPU at a
small size (3 objects, 32x32, filters [8, 16], latent 8, seeded random
weights and pools):

  * the step against the plain reference `portbench/reference/multipath.py`
    (a Python loop over the objects, each through the published
    upsample-then-conv decoder): the loss, every gradient and three Adam
    steps;
  * at n_o = 1 the bank's step equals the template AAE's bit for bit;
  * the stratified draw's layout, and the refusals of a batch that does
    not divide by n_o;
  * a misrouted bank (object o's rows through decoder o + 1) fails the
    comparison;
  * each stacked weight's init at one decoder's fan in;
  * the phase kernels and the grouped 2x convolution of a stack against
    each object's own;
  * a checkpoint round trip, `cli/ae_train` on a tiny multi-path cfg, and
    the ValueErrors of what the multi-path model does not support yet;
  * the procedural mesh's `seed`: the default mesh is the JAX package's.

No test renders through the JAX package."""

import configparser
import functools
import json
import math
import os

import numpy as np
import pytest
import torch

from augmentedautoencoder_torch import factory
from augmentedautoencoder_torch import workspace as ws
from augmentedautoencoder_torch.cli import ae_embed, ae_train
from augmentedautoencoder_torch.config import load_train_config
from augmentedautoencoder_torch.data.pipeline import DeviceDataset
from augmentedautoencoder_torch.models import AAE, DecoderBank
from augmentedautoencoder_torch.ops.fused_upconv import phase_kernels, upsample2x_conv
from augmentedautoencoder_torch.renderer.procedural import make_textured_asymmetric
from augmentedautoencoder_torch.training import CheckpointManager, Trainer
from augmentedautoencoder_torch.training.metrics import MetricWriter
from augmentedautoencoder_torch.training.state import init_parameters_, make_optimizer
from augmentedautoencoder_torch.training.trainer import make_train_step
from portbench.kinds import train
from portbench.reference import augment, compare, model, multipath

from _torch_port_ws import TINY_CFG, global_rng_guard  # noqa: F401 (global_rng_guard: autouse)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OBJ, PER, ROWS = 3, 4, 16
LIMITS = {"loss_gap": 2e-3, "grad_gap": 1e-4, "update_gap": 3e-2}


def _sections(n_objects=N_OBJ, **network):
    """The mp_tless30 configuration's cfg sections at the small size."""
    with open(os.path.join(REPO, "portbench", "configs", "mp_tless30.json")) as fh:
        sections = json.load(fh)["cfg"]
    sections["Dataset"].update(H="32", W="32", NOOF_TRAINING_IMGS=str(ROWS), NOOF_BG_IMGS="8")
    sections["Network"].update({"NUM_FILTER": "[8, 16]", "STRIDES": "[2, 2]", "LATENT_SPACE_SIZE": "8", **network})
    sections["Paths"]["MODEL_PATH"] = repr([f"/nonexistent/obj{o}.ply" for o in range(n_objects)])
    return sections


def _cfg(sections, batch=N_OBJ * PER):
    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    cp.read_string(train.cfg_text(sections, BATCH_SIZE=batch))
    np.random.seed(7)  # the CODE's np.random.rand()
    return load_train_config(cp)


def _pool(cfg, seed=0):
    rng = np.random.RandomState(seed)
    n, (h, w, c) = ROWS * cfg.n_objects, cfg.shape
    train_x = rng.randint(0, 256, (n, h, w, c), dtype=np.uint8)
    mask_x = rng.rand(n, h, w) < 0.5
    train_y = rng.randint(0, 256, (n, h, w, c), dtype=np.uint8)
    bg = rng.randint(0, 256, (cfg.noof_bg_imgs, h, w, c), dtype=np.uint8)
    return train_x, mask_x, train_y, np.count_nonzero(~mask_x, axis=(1, 2)), bg


def _trainer(cfg, pool, weights, seed):
    train_x, mask_x, train_y, n_obj, bg = pool
    ds = DeviceDataset(cfg, train_x, mask_x, train_y, bg, n_obj, n_objects=cfg.n_objects)
    trainer = Trainer(cfg, ds, seed=seed, metric_writer=train._Recorder())
    with torch.no_grad():
        for k, p in trainer.model.named_parameters():
            p.copy_(weights[k])
    return trainer


def _program_and_reference(seed, misrouted=False):
    sections = _sections()
    cfg = _cfg(sections)
    pool = _pool(cfg)
    arch = model.Arch(sections)
    weights = multipath.make_weights(arch, N_OBJ, seed, "cpu")
    trainer = _trainer(cfg, pool, weights, seed)
    if misrouted:
        from portbench.calibrate_mp import misroute

        misroute(trainer.model.decoder)
    rec = train.check_steps(trainer, trainer.metric_writer, 3)
    chain = augment.parse_code(sections["Augmentation"]["CODE"], 7)
    ref = multipath.reference_record(arch, N_OBJ, chain, augment.pool_on("cpu", *pool[:3], pool[4]), weights,
                                     seed, cfg.batch_size, 3)
    return rec, ref


@pytest.mark.parametrize("seed", [3, 2_400_000_017])
def test_step_matches_the_reference(seed):
    """Loss of each of three steps within 1e-5 relative; the first gradient
    (Adam's first moment over 1 - b1) of every leaf, and every parameter
    after the three steps, within f32 round-off of the reference's (its
    encoder sums the rows' gradients object by object, and its decoder
    convolves the upsampled map)."""
    rec, ref = _program_and_reference(seed)
    np.testing.assert_allclose(rec["losses"], ref["losses"], rtol=1e-5)
    assert set(rec["grad"]) == set(ref["grad"])
    for k, g in ref["grad"].items():
        scale = float(g.abs().max())
        torch.testing.assert_close(rec["grad"][k], g, rtol=1e-4, atol=1e-5 * scale, msg=k)
        torch.testing.assert_close(rec["pN"][k], ref["pN"][k], rtol=0, atol=1e-5, msg=k)
    assert compare.judge(compare.compare(rec, ref), LIMITS)


def test_misrouted_bank_fails_the_comparison():
    """Object o's rows through decoder o + 1: each decoder's own leaves
    (`per_object`) read far outside the limits."""
    from portbench.kinds.train_mp import compare_objects

    rec, ref = _program_and_reference(3, misrouted=True)
    numbers = compare_objects(rec, ref, N_OBJ)
    assert numbers["grad_gap"] > 100 * LIMITS["grad_gap"], numbers
    assert not compare.judge(numbers, LIMITS)


def _template_and_bank_steps(seed=5):
    """One step of the template AAE and one of a one-object bank from the
    same parameters and batch: (losses, gradients, parameters after)."""
    cfg = _cfg(_sections(n_objects=1), batch=6)
    torch.manual_seed(seed)
    template = AAE.from_config(cfg, train=True)
    init_parameters_(template, torch.Generator().manual_seed(seed))
    bank = AAE.from_config(cfg, train=True)
    bank.decoder = DecoderBank(1, (32, 32, 3), 8, (16, 8), 5, (2, 2))
    with torch.no_grad():
        for k, p in bank.named_parameters():
            p.copy_(dict(template.named_parameters())[k].reshape(p.shape))
    x, y = torch.rand(6, 32, 32, 3), torch.rand(6, 32, 32, 3)
    out = []
    for m in (template, bank):
        opt = make_optimizer(m, cfg)
        loss = m(x, y, train=True).total_loss
        loss.backward()
        grads = {k: p.grad.clone().reshape(-1) for k, p in m.named_parameters()}
        opt.step()
        out.append((loss.detach(), grads, {k: p.detach().reshape(-1) for k, p in m.named_parameters()}))
    return out


def test_one_object_bank_equals_the_template_bit_for_bit():
    (loss_t, g_t, p_t), (loss_b, g_b, p_b) = _template_and_bank_steps()
    assert torch.equal(loss_t, loss_b)
    assert set(g_t) == set(g_b)
    for k in g_t:
        assert torch.equal(g_t[k], g_b[k]), k
        assert torch.equal(p_t[k], p_b[k]), k


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_bank_decodes_each_objects_rows_as_its_decoder(dtype, tol):
    """The bank on a batch in object order equals each object's own
    `Decoder` (its slice of every stacked leaf) on that object's rows, in
    the compute precision of either (f32, or bf16 with the f32 head)."""
    from augmentedautoencoder_torch.models import Decoder

    torch.manual_seed(0)
    bank = DecoderBank(N_OBJ, (32, 32, 3), 8, (16, 8), 5, (2, 2), compute_dtype=dtype)
    for p in bank.parameters():
        torch.nn.init.normal_(p, std=0.2)
    z = torch.randn(N_OBJ * PER, 8)
    out = bank(z)
    assert out.shape == (N_OBJ * PER, 32, 32, 3) and out.dtype == torch.float32
    for o in range(N_OBJ):
        dec = Decoder((32, 32, 3), 8, (16, 8), 5, (2, 2), compute_dtype=dtype)
        with torch.no_grad():
            for k, p in dec.named_parameters():
                p.copy_(dict(bank.named_parameters())[k][o])
        torch.testing.assert_close(out[o * PER:(o + 1) * PER], dec(z[o * PER:(o + 1) * PER]), rtol=tol, atol=tol)


def test_stratified_draw_layout():
    cfg = _cfg(_sections())
    train_x, mask_x, train_y, n_obj, bg = _pool(cfg)
    ds = DeviceDataset(cfg, train_x, mask_x, train_y, bg, n_obj, n_objects=N_OBJ)
    idcs = ds.draw_batch(torch.Generator().manual_seed(1), N_OBJ * PER)["idcs"].view(N_OBJ, PER)
    for o in range(N_OBJ):
        assert ((idcs[o] >= o * ROWS) & (idcs[o] < (o + 1) * ROWS)).all()
        assert len(set(idcs[o].tolist())) == PER  # without replacement
    # a pool smaller than an object's rows draws with replacement
    big = ds.draw_batch(torch.Generator().manual_seed(1), N_OBJ * 2 * ROWS)["idcs"].view(N_OBJ, 2 * ROWS)
    assert all(((big[o] >= o * ROWS) & (big[o] < (o + 1) * ROWS)).all() for o in range(N_OBJ))
    x, y = ds.sample_batch(torch.Generator().manual_seed(1), N_OBJ * PER)
    assert x.shape == y.shape == (N_OBJ * PER, 32, 32, 3)
    assert torch.equal(y, ds.train_y[idcs.reshape(-1)].float() / 255.0)


@pytest.mark.parametrize("where", ["config", "draw", "pool"])
def test_batch_that_does_not_divide_is_rejected(where):
    cfg = _cfg(_sections())
    if where == "config":
        with pytest.raises(ValueError, match="does not divide by the 3 objects"):
            _cfg(_sections(), batch=10)
        return
    train_x, mask_x, train_y, n_obj, bg = _pool(cfg)
    if where == "draw":
        ds = DeviceDataset(cfg, train_x, mask_x, train_y, bg, n_obj, n_objects=N_OBJ)
        with pytest.raises(ValueError, match="does not divide"):
            ds.sample_batch(torch.Generator().manual_seed(0), 10)
    else:
        with pytest.raises(ValueError, match="equal object pools"):
            DeviceDataset(cfg, train_x[:-1], mask_x[:-1], train_y[:-1], bg, n_obj[:-1], n_objects=N_OBJ)


@pytest.mark.parametrize("leaf, fan_in", [("dense", 8), ("convs.0", 16 * 25), ("reconstruction", 16 * 25)])
def test_init_at_one_decoders_fan_in(leaf, fan_in):
    """Each object's slice of a stacked kernel has Flax's lecun-normal
    variance over one decoder's fan in (not the stack's), each object drawn
    from its own stream; biases 0."""
    cfg = _cfg(_sections(NUM_FILTER="[16, 16]"))
    m = AAE.from_config(cfg, train=True)
    init_parameters_(m, torch.Generator().manual_seed(0))
    layer = dict(m.decoder.named_modules())[leaf]
    w = layer.weight.detach()
    assert w.shape[0] == N_OBJ and (layer.bias == 0).all()
    for o in range(N_OBJ):
        n = w[o].numel()
        # the truncated normal's variance is 1/fan_in; its sample variance within 5 standard errors
        assert abs(float(w[o].var()) * fan_in - 1.0) < 5 * math.sqrt(2.0 / n) + 0.01, (o, float(w[o].var()) * fan_in)
        assert float(w[o].abs().max()) <= 2.0 / 0.87962566103423978 / math.sqrt(fan_in) + 1e-6
    assert not torch.equal(w[0], w[1])


def test_phase_kernels_and_grouped_conv_of_a_stack():
    """A stack's phase kernels are each object's, bit for bit, forward and
    backward; the grouped 2x convolution equals each object's own."""
    torch.manual_seed(0)
    w = torch.randn(3, 4, 5, 5, 5, requires_grad=True)
    k = phase_kernels(w)
    g = torch.randn_like(k)
    (gw,) = torch.autograd.grad(k, w, g)
    for o in range(3):
        wo = w.detach()[o].clone().requires_grad_(True)
        ko = phase_kernels(wo)
        assert torch.equal(k[o], ko)
        assert torch.equal(gw[o], torch.autograd.grad(ko, wo, g[o])[0])
    x, b = torch.randn(2, 3 * 5, 6, 6), torch.randn(3, 4)
    out = upsample2x_conv(x, w.detach(), b).view(2, 3, 4, 12, 12)
    for o in range(3):
        own = upsample2x_conv(x[:, 5 * o:5 * (o + 1)], w.detach()[o], b[o])
        torch.testing.assert_close(out[:, o], own, rtol=1e-5, atol=1e-5)


def test_checkpoint_round_trip(tmp_path):
    cfg = _cfg(_sections())
    pool = _pool(cfg)
    trainer = _trainer(cfg, pool, multipath.make_weights(model.Arch(_sections()), N_OBJ, 1, "cpu"), 1)
    trainer.train(num_iter=2, progress=False)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_train_state(trainer.step, trainer.model, trainer.optimizer)
    other = _trainer(cfg, pool, multipath.make_weights(model.Arch(_sections()), N_OBJ, 2, "cpu"), 1)
    payload = mgr.restore_train_state(other.model, other.optimizer)
    assert payload["step"] == 2 and payload["decoder"]["decoder.dense.weight"].shape[0] == N_OBJ
    for (k, a), (_, b) in zip(trainer.model.state_dict().items(), other.model.state_dict().items()):
        assert torch.equal(a, b), k
    for name, slot in trainer.optimizer.state_dict()["slots"].items():
        for k, v in slot.items():
            assert torch.equal(v, other.optimizer.state_dict()["slots"][name][k]), (name, k)
    # both continue alike
    other.step = trainer.step
    trainer.train(num_iter=3, progress=False)
    other.train(num_iter=3, progress=False)
    for (k, a), (_, b) in zip(trainer.model.state_dict().items(), other.model.state_dict().items()):
        assert torch.equal(a, b), k


@pytest.fixture
def mp_ws(tmp_path, monkeypatch):
    """A workspace with experiment `mp`: 3 seeded procedural meshes, 8
    renders an object, 6 backgrounds, batch 6 (2 rows an object), 4 steps."""
    import cv2

    from augmentedautoencoder_torch.renderer.procedural import save_ply

    monkeypatch.setattr(ae_train, "MetricWriter", functools.partial(MetricWriter, use_tensorboard=False))
    meshes = []
    for seed in (1, 2, 3):
        meshes.append(str(tmp_path / f"obj{seed}.ply"))
        save_ply(make_textured_asymmetric(subdivisions=2, radius=45.0, seed=seed), meshes[-1])
    bg = tmp_path / "bg"
    bg.mkdir()
    rng = np.random.RandomState(0)
    for i in range(6):
        cv2.imwrite(str(bg / f"{i}.png"), rng.randint(0, 256, (40, 50, 3)).astype(np.uint8))
    text = (TINY_CFG.replace("/nonexistent/model.ply", repr(meshes)).replace("/nonexistent/*.jpg", str(bg / "*.png"))
            .replace("NOOF_BG_IMGS: 0", "NOOF_BG_IMGS: 6").replace("NOOF_TRAINING_IMGS: 4", "NOOF_TRAINING_IMGS: 8")
            .replace("NUM_ITER: 10", "NUM_ITER: 4").replace("SAVE_INTERVAL: 10", "SAVE_INTERVAL: 2"))
    text = text.replace("BATCH_SIZE: 8", "BATCH_SIZE: 6")
    root = str(tmp_path / "ws")
    monkeypatch.setenv(ws.WORKSPACE_ENV_VAR, root)
    ws.init_workspace(root)
    with open(ws.get_config_file_path(root, "mp"), "w") as fh:
        fh.write(text)
    return root


def test_ae_train_trains_a_multipath_model(mp_ws):
    trainer = ae_train.main(["mp"], device="cpu")
    assert trainer.step == 4 and trainer.model.n_objects == 3
    assert isinstance(trainer.model.decoder, DecoderBank)
    assert trainer.dataset.train_x.shape[0] == 3 * 8
    # each object rendered apart: three distinct pools
    pools = trainer.dataset.train_y.view(3, 8, -1).float().mean(dim=(1, 2))
    assert len(set(pools.tolist())) == 3
    paths = factory.experiment_paths("mp")
    assert CheckpointManager(paths["checkpoint_dir"]).all_steps() == [2, 4]
    payload = CheckpointManager(paths["checkpoint_dir"]).restore()
    assert payload["decoder"]["decoder.convs.0.weight"].shape[0] == 3
    # embedding and serving it are refused with a message, not misread
    with pytest.raises(ValueError, match="multi-path model of 3 objects"):
        ae_embed.main(["mp"], device="cpu")
    with pytest.raises(ValueError, match="multi-path model of 3 objects"):
        factory.restore_experiment("mp", device="cpu")


@pytest.mark.parametrize("key, value", [("VARIATIONAL", "0.1"), ("AUXILIARY_MASK", "True"),
                                        ("BATCH_NORMALIZATION", "True")])
def test_variants_are_refused(key, value):
    cfg = _cfg(_sections(**{key: value}))
    with pytest.raises(ValueError, match="multi-path model"):
        AAE.from_config(cfg, train=True)


def test_a_mesh_is_refused():
    cfg = _cfg(_sections())
    m = AAE.from_config(cfg, train=True)
    with pytest.raises(ValueError, match="trains on one device"):
        make_train_step(m, make_optimizer(m, cfg), None, cfg.batch_size, mesh=object())


def test_procedural_mesh_seed():
    """The default mesh is the JAX package's bit for bit (the benchmark's
    cached pools stay valid); each seed gives another object."""
    from augmentedautoencoder_tpu.renderer.procedural import make_textured_asymmetric as jax_mesh

    a, b = make_textured_asymmetric(subdivisions=2, radius=40.0), jax_mesh(subdivisions=2, radius=40.0)
    for field in ("vertices", "normals", "faces", "colors"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    s1, s1b, s2 = (make_textured_asymmetric(subdivisions=2, radius=40.0, seed=s) for s in (1, 1, 2))
    assert np.array_equal(s1.vertices, s1b.vertices)
    assert not np.allclose(s1.vertices, s2.vertices) and not np.allclose(s1.vertices, a.vertices)
    assert np.array_equal(s1.faces, a.faces)


def test_config_lists_meshes():
    cfg = _cfg(_sections())
    assert cfg.n_objects == 3 and cfg.model_paths[2] == "/nonexistent/obj2.ply"
    one = cfg.for_object(1)
    assert one.n_objects == 1 and one.model_path == "/nonexistent/obj1.ply"
    assert "obj1.ply" in one.dataset_cache_items() and "obj2.ply" not in one.dataset_cache_items()
    single = _cfg(_sections(n_objects=1))
    assert single.n_objects == 1 and single.for_object(0) is single
