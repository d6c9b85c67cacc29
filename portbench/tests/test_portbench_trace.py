"""The per-layer arithmetic on synthetic traces: the idle share from the
union of device intervals, attribution of device time to the spans, host
issue time, MFU and the convolutions' roofline share."""

import pytest

from portbench.metrics import (_flops, _peaks, batch_device_ms, conv_roofline, device_idle_pct, host_issue_ms,
                               model_step_device_ms, optimizer_device_ms, train_mfu_pct)
from portbench.metrics._trace import Trace, union
from portbench.readings import Readings

MAIN, BW = 1, 2


def X(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 0, "args": args}


def step_events(t0, corr0):
    """One step from t0 (us): spans on the main thread, a backward op on the
    autograd thread, one kernel per layer; the optimizer's launch blocks
    (300 us against a median launch of 5 us)."""
    ev = [X("user_annotation", "portbench.step", t0, 1000),
          X("user_annotation", "portbench.sample_batch", t0, 100),
          X("cpu_op", "aten::index", t0 + 10, 50),
          X("cuda_runtime", "cudaLaunchKernel", t0 + 20, 5, correlation=corr0),
          X("kernel", "gather_kernel", t0 + 30, 40, correlation=corr0),
          X("user_annotation", "portbench.forward", t0 + 100, 200),
          X("cpu_op", "aten::cudnn_convolution", t0 + 110, 50),
          X("cuda_runtime", "cudaLaunchKernel", t0 + 120, 5, correlation=corr0 + 1),
          X("kernel", "conv_fprop", t0 + 130, 200, correlation=corr0 + 1),
          # a second kernel overlapping the first on another stream: counted once in the union
          X("cpu_op", "aten::relu", t0 + 165, 20),
          X("cuda_runtime", "cudaLaunchKernel", t0 + 170, 5, correlation=corr0 + 2),
          X("kernel", "elementwise", t0 + 180, 100, correlation=corr0 + 2),
          X("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", t0 + 320, 200, tid=BW),
          X("cpu_op", "aten::convolution_backward", t0 + 330, 150, tid=BW),
          X("cuda_runtime", "cudaLaunchKernel", t0 + 340, 5, tid=BW, correlation=corr0 + 3),
          X("kernel", "conv_dgrad", t0 + 400, 300, correlation=corr0 + 3),
          X("user_annotation", "portbench.optimizer", t0 + 600, 400),
          X("cpu_op", "aten::add_", t0 + 610, 350),
          X("cuda_runtime", "cudaLaunchKernel", t0 + 620, 300, correlation=corr0 + 4),
          X("kernel", "adam_update", t0 + 920, 50, correlation=corr0 + 4)]
    return ev


@pytest.fixture
def trace():
    events = [X("user_annotation", "portbench.window", 0, 2000)]
    events += step_events(0, 10) + step_events(1000, 20)
    # a kernel outside the window does not count
    events += [X("cuda_runtime", "cudaLaunchKernel", 2500, 5, correlation=99),
               X("kernel", "late", 2600, 10, correlation=99)]
    return Trace(events)


def test_union_counts_overlap_once():
    assert union([(0, 10), (5, 20), (30, 40)]) == [(0, 20), (30, 40)]


def test_attribution_to_layers(trace):
    by = {o.name: (o.layer, o.op) for o in trace.ops}
    assert by["gather_kernel"] == ("sample_batch", "aten::index")
    assert by["conv_fprop"] == ("forward", "aten::cudnn_convolution")
    assert by["conv_dgrad"] == ("backward", "aten::convolution_backward")
    assert by["adam_update"] == ("optimizer", "aten::add_")
    assert "late" not in by
    r = Readings(trace=trace, steps_traced=2)
    assert batch_device_ms.read(r) == pytest.approx(0.040)
    assert model_step_device_ms.read(r) == pytest.approx((200 + 100 + 300) / 1e3)
    assert optimizer_device_ms.read(r) == pytest.approx(0.050)


def test_idle_share_is_the_union_not_the_sum(trace):
    # a step's device intervals: 30-70, 130-330 (180-280 inside it), 400-700, 920-970
    busy = 2 * (40 + 200 + 300 + 50)
    assert trace.busy_us() == pytest.approx(busy)
    assert device_idle_pct.read(Readings(trace=trace, steps_traced=2)) == pytest.approx(100 * (1 - busy / 2000))
    gaps = trace.gaps()
    assert sum(e - s for (s, e), _ in gaps) == pytest.approx(2000 - busy)
    assert gaps[0][1].name == "gather_kernel" and gaps[-1][1] is None


def test_host_issue_leaves_out_waits_and_the_backward_call(trace):
    # a step: 1000 us, less the backward call 300-600 and 295 us of the blocked
    # launch, plus the autograd thread's 200 us of operators
    assert host_issue_ms.read(Readings(trace=trace, steps_traced=2)) == pytest.approx((1000 - 300 - 295 + 200) / 1e3)


def test_mfu_and_roofline_arithmetic(trace):
    ops = [{"kind": "conv", "dtype": "float32", "flops": 67e9, "bytes": 0.0},
           {"kind": "matmul", "dtype": "float32", "flops": 33e9, "bytes": 0.0}]
    r = Readings(trace=trace, steps_traced=2, window_steps=10, window_s=1.0, precision="float32", step_ops=ops)
    assert train_mfu_pct.read(r) == pytest.approx(100 * 100e9 * 10 / 67e12)
    # conv kernels: conv_fprop and conv_dgrad, 500 us a step; the least time 1 ms
    assert conv_roofline.read(r) == pytest.approx(100 * 1e-3 / 500e-6)
    assert _peaks.least_seconds([{"dtype": "bfloat16", "flops": 0.0, "bytes": 3.35e12}]) == pytest.approx(1.0)


def test_readers_return_nothing_without_a_device_trace():
    empty = Trace([X("user_annotation", "portbench.window", 0, 100)])
    for reader in (batch_device_ms, model_step_device_ms, optimizer_device_ms, device_idle_pct, conv_roofline):
        assert reader.read(Readings(trace=empty, steps_traced=1, step_ops=[{"kind": "conv"}])) is None
        assert reader.read(Readings()) is None


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_step_flops_equal_the_flop_counter_on_the_port(precision):
    """The frozen shape arithmetic against torch.utils.flop_counter on the
    port's model at the template's shapes (meta tensors, no compute)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from augmentedautoencoder_torch.config import load_train_config
    from augmentedautoencoder_torch.models import AAE

    from .conftest import ROOT

    cfg = load_train_config(f"{ROOT}/augmentedautoencoder_torch/cfg_templates/train_template.cfg")
    cfg.precision = precision
    with torch.device("meta"):
        model = AAE.from_config(cfg, train=True).train()
        x = torch.empty((64,) + tuple(cfg.shape))
        with FlopCounterMode(display=False) as counter:
            model(x, x, train=True).total_loss.backward()
    ops = _flops.step_ops(128, 128, 3, [128, 256, 512, 512], 5, 5, 128, 64, precision)
    assert sum(o["flops"] for o in ops) == counter.get_total_flops()
    assert {o["dtype"] for o in ops if "reconstruction" in o["name"] or "latent" in o["name"]} == {"float32"}
