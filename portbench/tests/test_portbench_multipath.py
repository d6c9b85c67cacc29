"""The multi-path cell's harness on the CPU at a tiny width (3 objects,
32x32, filters [8, 16], latent 8, a seeded random pool): the kind end to
end, `calibrate_mp.py`'s faults and control against the cell's limits,
the decoder bank's readers on a hand-built trace and on one the profiler
records, and `_flops_mp`'s counts."""

import json

import numpy as np
import pytest
import torch

from portbench import calibrate_mp, run
from portbench.kinds import train_mp
from portbench.metrics import (_flops, _flops_mp, decoder_bank_device_ms, decoder_bank_launches,
                               decoder_bank_roofline, train_mfu_pct)
from portbench.metrics._bank import BankTrace
from portbench.readings import Readings
from portbench.reference import compare

from . import tiny

CELL = "train_mp30_f32_b240"
TRAFFIC = {"kind": "train_mp", "batch_size": 12, "log_every": 10, "check_steps": 3, "warmup_steps": 2,
           "trace_steps": 4}


def _config():
    config = tiny.config("mp_tless30")
    config["pool"]["mesh_seeds"] = [1, 2, 3]
    return config


def _random_pool(config, cfg, data_dir):
    rng = np.random.RandomState(0)
    n, (h, w, c) = cfg.noof_training_imgs * cfg.n_objects, cfg.shape
    train_x = rng.randint(0, 256, (n, h, w, c), dtype=np.uint8)
    mask_x = rng.rand(n, h, w) < 0.5
    train_y = rng.randint(0, 256, (n, h, w, c), dtype=np.uint8)
    bg = rng.randint(0, 256, (cfg.noof_bg_imgs, h, w, c), dtype=np.uint8)
    return train_x, mask_x, train_y, np.count_nonzero(~mask_x, axis=(1, 2)), bg


@pytest.fixture
def mp(monkeypatch, tmp_path):
    """The kind on a random pool, its meshes written under tmp_path."""
    monkeypatch.setattr(train_mp, "load_pool", _random_pool)
    return str(tmp_path)


def _manifest():
    with open(f"{tiny.ROOT}/BENCHMARK.json") as fh:
        return json.load(fh)


@pytest.mark.parametrize("trace", [False, True])
def test_the_kind_end_to_end(mp, trace):
    manifest = _manifest()
    cell = next(w for w in manifest["workloads"] if w["name"] == CELL)
    config = _config()
    out = train_mp.run(config, TRAFFIC, 2_400_000_101, 0.5, trace, "cpu", mp, tiny.limits(CELL), 0.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    result = run.result_of(manifest, cell, trace, train_mp, out, {"platform": "cpu"})
    metrics = result["metrics"]
    if trace:
        # the CPU launches nothing: the bank is found, with no device work to read
        assert metrics["decoder_bank_launches"]["value"] == 0.0
        assert "decoder_bank_roofline" not in metrics
        assert {"model_host_ms", "step_launches", "train_mfu_pct"} <= set(metrics)
    else:
        assert set(metrics) == {"train_samples_per_s", "setup_s"}


def test_faults_and_control_fail_the_limits(mp):
    rows = calibrate_mp.readings(CELL, [5], [5], [5], "cpu", _config(), TRAFFIC, mp)
    limits = tiny.limits(CELL)
    by = {r["kind"]: r for r in rows}
    assert set(by) == {"sound", "control", "half_batch", "unchanged", "misrouted"}
    assert compare.judge(by["sound"], limits), by["sound"]
    for kind in ("control", "half_batch", "unchanged", "misrouted"):
        assert not compare.judge(by[kind], limits), (kind, {k: by[kind][k] for k in limits})


def test_the_kind_stops_before_rendering_on_a_program_without_multipath(mp, monkeypatch):
    """A port that reads MODEL_PATH as one path (as before the multi-path
    model) fails at the parse, before any pool is loaded."""
    import augmentedautoencoder_torch.config as config_pkg

    monkeypatch.setattr(train_mp, "load_pool", lambda *a: pytest.fail("the pool was loaded"))
    real = config_pkg.load_train_config

    def one_object(cp):
        cfg = real(cp)
        cfg.model_path = "/one/mesh.ply"
        return cfg

    monkeypatch.setattr(config_pkg, "load_train_config", one_object)
    with pytest.raises(RuntimeError, match="reads 1 objects"):
        train_mp.build(_config(), TRAFFIC, 1, "cpu", mp)


MAIN, ENGINE = 1, 2


def X(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 0, "args": args}


def _step(t0, corr0, seq0):
    """One step from t0 (us): the bank's span with two launching operators
    (sequence numbers seq0, seq0 + 1) and an encoder operator before it;
    on the engine thread the backward of both bank operators and of the
    encoder's, each launching one kernel."""
    seq = lambda n: {"Sequence number": n, "Fwd thread id": 0}
    return [
        X("cpu_op", "aten::convolution", t0, 20, **seq(seq0 - 1)),
        X("cuda_runtime", "cudaLaunchKernel", t0 + 5, 5, correlation=corr0),
        X("kernel", "encoder_fprop", t0 + 10, 100, correlation=corr0),
        X("user_annotation", "aae.ops.decoder_bank", t0 + 30, 100),
        X("cpu_op", "aten::baddbmm", t0 + 35, 20, **seq(seq0)),
        X("cuda_runtime", "cudaLaunchKernel", t0 + 40, 5, correlation=corr0 + 1),
        X("kernel", "bank_gemm", t0 + 110, 50, correlation=corr0 + 1),
        X("cpu_op", "aten::convolution", t0 + 60, 20, **seq(seq0 + 1)),
        X("cuda_runtime", "cudaLaunchKernel", t0 + 65, 5, correlation=corr0 + 2),
        X("cuda_runtime", "cudaMemsetAsync", t0 + 72, 3, correlation=corr0 + 3),
        X("gpu_memset", "Memset", t0 + 160, 10, correlation=corr0 + 3),
        X("kernel", "bank_fprop", t0 + 170, 200, correlation=corr0 + 2),
        X("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", t0 + 400, 50, tid=ENGINE,
          **seq(seq0 + 1)),
        X("cuda_runtime", "cudaLaunchKernel", t0 + 410, 5, tid=ENGINE, correlation=corr0 + 4),
        X("kernel", "bank_dgrad", t0 + 420, 300, correlation=corr0 + 4),
        X("cpu_op", "autograd::engine::evaluate_function: BaddbmmBackward0", t0 + 460, 30, tid=ENGINE,
          **seq(seq0)),
        X("cuda_runtime", "cudaLaunchKernel", t0 + 465, 5, tid=ENGINE, correlation=corr0 + 5),
        X("kernel", "bank_wgrad", t0 + 720, 40, correlation=corr0 + 5),
        X("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", t0 + 500, 30, tid=ENGINE,
          **seq(seq0 - 1)),
        X("cuda_runtime", "cudaLaunchKernel", t0 + 505, 5, tid=ENGINE, correlation=corr0 + 6),
        X("kernel", "encoder_dgrad", t0 + 760, 80, correlation=corr0 + 6),
    ]


def test_bank_readers_on_a_hand_built_trace():
    events = [X("user_annotation", "portbench.window", 0, 2000)] + _step(0, 10, 100) + _step(1000, 20, 200)
    trace = BankTrace(events)
    # a step's bank: bank_gemm 50, Memset 10, bank_fprop 200, bank_dgrad 300, bank_wgrad 40; 5 launches
    assert trace.bank_us == pytest.approx(2 * 600)
    assert trace.bank_launches == 2 * 5
    ops = [{"kind": "conv", "name": "decoder.convs.0.fwd", "dtype": "float32", "flops": 20.1e6, "bytes": 0.0},
           {"kind": "conv", "name": "encoder.convs.0.fwd", "dtype": "float32", "flops": 67e9, "bytes": 0.0}]
    r = Readings(trace=trace, steps_traced=2, step_ops=ops)
    assert decoder_bank_device_ms.read(r) == pytest.approx(0.6)
    assert decoder_bank_launches.read(r) == pytest.approx(5)
    # least time 20.1e6 / 67e12 s = 0.3 us over 600 us
    assert decoder_bank_roofline.read(r) == pytest.approx(100 * 0.3 / 600)
    plain = BankTrace([X("user_annotation", "portbench.window", 0, 2000)] + _step(0, 10, 100)[:3])
    for reader in (decoder_bank_device_ms, decoder_bank_launches, decoder_bank_roofline):
        assert reader.read(Readings(trace=plain, steps_traced=1, step_ops=ops)) is None
        assert reader.read(Readings()) is None


def test_bank_device_time_counts_overlapping_operations_once():
    """Two of the bank's kernels that run at once, on two streams, count
    once: bank_wgrad moved to start 20 us before bank_dgrad ends."""
    step = _step(0, 10, 100)
    for e in step:
        if e["name"] == "bank_wgrad":
            e["ts"], e["args"]["stream"] = 700, 13
    trace = BankTrace([X("user_annotation", "portbench.window", 0, 2000)] + step)
    assert trace.bank_us == pytest.approx(600 - 20)
    assert trace.bank_launches == 5
    assert decoder_bank_device_ms.read(Readings(trace=trace, steps_traced=1)) == pytest.approx(0.58)


def test_bank_trace_finds_the_profilers_sequence_numbers():
    """On a trace the profiler records of the bank's forward and backward
    (CPU: no launches), the span's operators' backward nodes are found by
    their sequence numbers, and nothing else."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from augmentedautoencoder_torch.models import DecoderBank

    bank = DecoderBank(2, (16, 16, 3), 4, (8, 4), 5, (2, 2))
    for p in bank.parameters():
        torch.nn.init.normal_(p, std=0.1)
    z = torch.randn(4, 4, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.window"):
            (bank(torch.tanh(z)) ** 2).sum().backward()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    trace = BankTrace(events)
    assert trace.bank_us == 0.0 and trace.bank_launches == 0
    seqs = {e["args"]["Sequence number"] for e in events if e.get("name", "").startswith("aten::tanh")
            and "Sequence number" in e.get("args", {})}
    nodes = [e["name"] for e in events if e.get("name", "").startswith("autograd::engine::evaluate_function")]
    assert any("BaddbmmBackward" in n for n in nodes) and any("_PhaseKernels" in n for n in nodes)
    assert seqs  # the operator outside the span has its own sequence number


def test_flops_mp_at_one_object_is_the_template():
    args = (128, 128, 3, [128, 256, 512, 512], 5, 5, 128)
    for precision in ("float32", "bfloat16"):
        assert _flops_mp.step_ops(*args, 1, 64, precision) == _flops.step_ops(*args, 64, precision)
    mp = _flops_mp.step_ops(*args, 30, 240, "float32")
    # as many rows through the encoder and through some decoder as the template at 240
    assert sum(o["flops"] for o in mp) == sum(o["flops"] for o in _flops.step_ops(*args, 240, "float32"))
    one = sum(o["bytes"] for o in _flops_mp.bank_ops(_flops.step_ops(*args, 8, "float32")))
    assert sum(o["bytes"] for o in _flops_mp.bank_ops(mp)) == 30 * one
    r = Readings(window_steps=10, window_s=1.0, precision="float32", step_ops=mp)
    assert train_mfu_pct.read(r) == pytest.approx(100 * 10 * sum(o["flops"] for o in mp) / 67e12)


def test_flops_mp_equal_the_flop_counter_on_the_port():
    """The forward's shape arithmetic against torch.utils.flop_counter on the
    port's multi-path model (meta tensors, no compute), at 30 objects x 8
    rows of the template's widths: the bank's batched matmul and grouped
    convolutions count as 30 decoders at 8 rows. (The counter takes a
    grouped convolution's weight gradient for an ungrouped one, 30 times
    too large, so the backward is held by `_flops.step_ops`'s own test.)"""
    import configparser

    from torch.utils.flop_counter import FlopCounterMode

    from augmentedautoencoder_torch.config import load_train_config
    from augmentedautoencoder_torch.models import AAE

    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    cp.read(f"{tiny.ROOT}/augmentedautoencoder_torch/cfg_templates/train_template.cfg")
    cp.set("Paths", "MODEL_PATH", repr([f"/m{o}.ply" for o in range(30)]))
    cp.set("Training", "BATCH_SIZE", "240")
    cfg = load_train_config(cp)
    with torch.device("meta"):
        model = AAE.from_config(cfg, train=True).train()
        x = torch.empty((240,) + tuple(cfg.shape))
        with FlopCounterMode(display=False) as counter:
            model(x, x, train=True)
    ops = _flops_mp.step_ops(128, 128, 3, [128, 256, 512, 512], 5, 5, 128, 30, 240, "float32")
    assert sum(o["flops"] for o in ops if o["name"].endswith(".fwd")) == counter.get_total_flops()
