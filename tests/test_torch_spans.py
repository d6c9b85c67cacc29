"""The port's spans (training/profiler.span) on a tiny trainer, under a CPU
torch.profiler: each `aae.train.step` holds the batch, forward, backward
and optimizer spans in that order and the log block; the phase kernels and
the bootstrapped loss show inside the forward; with no profiler a span is
one shared no-op; and tracing changes no number."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from augmentedautoencoder_torch.config import TrainConfig
from augmentedautoencoder_torch.data import augment_spec as TS
from augmentedautoencoder_torch.data.pipeline import DeviceDataset
from augmentedautoencoder_torch.training import Trainer, profiler
from augmentedautoencoder_torch.training.profiler import StageTimer, span

from _torch_port_ws import global_rng_guard  # noqa: F401 (autouse)

torch.set_num_threads(1)

H = 32
STEPS = 3
PARTS = ["aae.train.sample_batch", "aae.train.forward", "aae.train.backward", "aae.train.optimizer"]


class _Writer:
    def __init__(self):
        self.rows = []

    def write_scalars(self, step, scalars):
        self.rows.append((step, scalars))


def _trainer(**kw):
    cfg = TrainConfig(h=H, w=H, c=3, latent_space_size=8)
    cfg.num_filter, cfg.strides = [4, 8], [2, 2]
    cfg.batch_size, cfg.learning_rate, cfg.noof_training_imgs = 8, 1e-3, 16
    cfg.code = TS.Sequential([TS.Sometimes(0.5, TS.Multiply(mul=(0.8, 1.2)))])
    for k, v in kw.items():
        setattr(cfg, k, v)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 255, (16, H, H, 3), dtype=np.uint8)
    masks = rng.rand(16, H, H) > 0.6
    bg = rng.randint(0, 255, (4, H, H, 3), dtype=np.uint8)
    ds = DeviceDataset(cfg, x, masks, x.copy(), bg, device="cpu")
    writer = _Writer()
    return Trainer(cfg, ds, seed=5, metric_writer=writer), writer


def _traced(trainer, tmp_path, steps=STEPS):
    """The `aae.` spans of `steps` steps through Trainer.train under a CPU
    profiler, from its exported Chrome trace, in time order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train(num_iter=trainer.step + steps, log_every=1, progress=False)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X" and e["name"].startswith("aae.")),
                  key=lambda e: (e["ts"], -e["dur"]))


def _inside(events, outer):
    lo, hi = outer["ts"], outer["ts"] + outer["dur"]
    return [e for e in events if e is not outer and lo <= e["ts"] and e["ts"] + e["dur"] <= hi]


def test_each_step_holds_its_parts_in_order(tmp_path):
    trainer, _ = _trainer()
    events = _traced(trainer, tmp_path)
    steps = [e for e in events if e["name"] == "aae.train.step"]
    assert len(steps) == STEPS
    for st in steps:
        inside = _inside(events, st)
        assert all(e["tid"] == st["tid"] for e in inside)
        assert [e["name"] for e in inside if e["name"] in PARTS] == PARTS
        assert [e["name"] for e in inside].count("aae.train.log") == 1
    # the flush at the end of train() follows the last step
    flush = [e for e in events if e["name"] == "aae.train.flush"]
    assert flush and flush[-1]["ts"] >= steps[-1]["ts"] + steps[-1]["dur"]


@pytest.mark.parametrize("variant, fused, bootstrap", [
    ({}, 2, 1),
    ({"batch_normalization": True, "auxiliary_mask": True}, 3, 1),
    ({"bootstrap_ratio": 1}, 2, 0),
], ids=["plain", "bn_aux", "no_bootstrap"])
def test_phase_kernels_and_bootstrap_inside_the_forward(tmp_path, variant, fused, bootstrap):
    # the tiny decoder's 2x steps: one conv layer (8 -> 16) and the head (16 -> 32),
    # plus the mask head with auxiliary_mask
    trainer, _ = _trainer(**variant)
    events = _traced(trainer, tmp_path)
    forwards = [e for e in events if e["name"] == "aae.train.forward"]
    assert len(forwards) == STEPS
    for f in forwards:
        names = [e["name"] for e in _inside(events, f)]
        assert names.count("aae.ops.phase_kernels") == fused
        assert names.count("aae.loss.bootstrap") == bootstrap
    assert sum(e["name"] == "aae.ops.phase_kernels" for e in events) == fused * STEPS


def test_no_profiler_one_shared_no_op(monkeypatch):
    assert not torch.autograd._profiler_enabled()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) made with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = span("train.step")
    assert first is span("train.forward") is profiler._NO_SPAN
    with first as entered:
        assert entered is None
    trainer, writer = _trainer()
    trainer.train(num_iter=2, log_every=1, progress=False)
    assert [s for s, _ in writer.rows] == [1, 2]


def test_tracing_changes_no_number(tmp_path):
    plain, plain_log = _trainer()
    plain.train(num_iter=STEPS, log_every=1, progress=False)
    traced, traced_log = _trainer()
    _traced(traced, tmp_path)
    assert traced_log.rows == plain_log.rows and len(plain_log.rows) == STEPS
    for (k, a), (_, b) in zip(plain.model.state_dict().items(), traced.model.state_dict().items()):
        assert torch.equal(a, b), k
    for s, d in plain.optimizer.slots.items():
        for k, v in d.items():
            assert torch.equal(traced.optimizer.slots[s][k], v), (s, k)


def test_stage_timer_sums_and_shows_as_a_span():
    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timer.stage("crop"):
                torch.ones(4).sum()
    with timer.stage("crop"):
        pass
    assert timer.summary()["crop"]["count"] == 4
    assert timer.total("crop") == pytest.approx(4 * timer.mean("crop")) and timer.total("crop") > 0.0
    assert sum(e.name == "aae.crop" for e in prof.events()) == 3
