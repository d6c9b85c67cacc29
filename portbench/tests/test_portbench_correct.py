"""`correct` on the CPU at a tiny width: the reference equals the port, the
control (the reference one precision lower) fails the cell's limits, and a
run with the timed path broken underneath comes out not correct. The run
skips the harness's look for a card and drives the rest of it."""

import json
import math

import pytest
import torch

from portbench import run
from portbench.kinds import train
from portbench.reference import compare, lowp

from . import tiny

CELLS = {"float32": "train_f32_b64", "bfloat16": "train_bf16_b64"}
MANIFEST = {"end_to_end": [{"name": "train_samples_per_s", "unit": "samples/s"}, {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "train_mfu_pct", "unit": "%"}, {"name": "host_issue_ms", "unit": "ms"}]}


def _run(cell, config, seed=3_000_000_019, trace=False):
    return run.run_cell(MANIFEST, {"name": cell, "config": config["name"]}, config, tiny.TRAFFIC,
                        tiny.limits(cell), seed, 0.5, trace, "cpu")


@pytest.mark.parametrize("name, precision", [("aae_template", "float32"), ("aae_template_bf16", "bfloat16")])
def test_sound_run_is_correct(monkeypatch, name, precision):
    tiny.patch_pool(monkeypatch)
    config = tiny.config(name)
    assert train.precision_of(config) == precision
    result = _run(CELLS[precision], config)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def test_result_line_follows_the_contract(monkeypatch):
    tiny.patch_pool(monkeypatch)
    result = _run("train_f32_b64", tiny.config(), trace=True)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks" and set(result["checks"]) == set(tiny.limits("train_f32_b64"))
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "train_mfu_pct" in result["metrics"] and "host_issue_ms" in result["metrics"]
    json.dumps(run._finite(result), allow_nan=False)
    assert run._finite({"x": [math.inf]}) == {"x": ["inf"]}


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "train_f32_b64", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def _half_batch(whole):
    def sample_batch(self, gen, batch_size, shard=(0, 1)):
        return tuple(t[: batch_size // 2] for t in whole(self, gen, batch_size, shard))

    return sample_batch


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    from augmentedautoencoder_torch.data.pipeline import DeviceDataset
    from augmentedautoencoder_torch.training.state import OptaxOptimizer

    tiny.patch_pool(monkeypatch)
    if fault == "half_batch":
        monkeypatch.setattr(DeviceDataset, "sample_batch", _half_batch(DeviceDataset.sample_batch))
    else:
        monkeypatch.setattr(OptaxOptimizer, "step", lambda self: None)
    result = _run("train_f32_b64", tiny.config())
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name, precision", [("aae_template", "float32"), ("aae_template_bf16", "bfloat16")])
def test_control_fails_the_limits(monkeypatch, name, precision):
    """The reference with its operands one precision lower, in the program's
    place, against the reference: outside the cell's limits."""
    tiny.patch_pool(monkeypatch)
    config = tiny.config(name)
    seed = 3_000_000_023
    _, _, pool = train.build(config, tiny.TRAFFIC, seed, "cpu", "/nonexistent")
    ref = train.reference(config, tiny.TRAFFIC, seed, "cpu", pool)
    control = train.reference(config, tiny.TRAFFIC, seed, "cpu", pool,
                              lowp.operand_rounding(lowp.CONTROL_OF[precision]))
    numbers = compare.compare(control, ref)
    assert not compare.judge(numbers, tiny.limits(CELLS[precision])), numbers


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, 3.0])
    assert lowp.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 3.0]
