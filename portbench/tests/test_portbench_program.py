"""The readers of the program's own spans (`aae.*`) on a synthetic trace:
self time without child spans and waits, the autograd thread's operators
inside the backward span, syncs and launches counted by span, and the idle
gaps that a sync ends."""

import pytest

from portbench.metrics import (_program, batch_host_ms, device_idle_pct, idle_sync_pct, loop_host_ms, model_host_ms,
                               optimizer_host_ms, step_launches, step_syncs)
from portbench.metrics._trace import Trace
from portbench.readings import Readings

MAIN, BW = 1, 2
NEW = (loop_host_ms, batch_host_ms, model_host_ms, optimizer_host_ms, step_syncs, step_launches, idle_sync_pct)


def X(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 0, "args": args}


def span(name, ts, dur, tid=MAIN):
    return X("user_annotation", "aae." + name, ts, dur, tid)


def step_events(t0, corr):
    """One step of 1000 us from t0. The phase kernels' copy synchronizes
    (102 us, returning at t0 + 322 while the card idles until t0 + 360); the
    optimizer's launch blocks (100 us against a median launch of 5 us)."""
    c = iter(range(corr, corr + 10))
    launch = lambda name, ts, dur, tid=MAIN, **kw: X("cuda_runtime", name, ts, dur, tid, correlation=kw.get("k"))
    k = lambda name, ts, dur, cc, cat="kernel": X(cat, name, ts, dur, correlation=cc)
    ev = [span("train.step", t0, 1000),
          span("train.sample_batch", t0 + 10, 90),
          X("cpu_op", "aten::index", t0 + 20, 50)]
    cc = next(c)
    ev += [launch("cudaLaunchKernel", t0 + 30, 5, k=cc), k("gather", t0 + 40, 30, cc),
           span("train.forward", t0 + 100, 300),
           X("cpu_op", "aten::cudnn_convolution", t0 + 110, 40)]
    cc = next(c)
    ev += [launch("cudaLaunchKernel", t0 + 115, 5, k=cc), k("conv", t0 + 120, 200, cc),
           span("ops.phase_kernels", t0 + 200, 130),
           X("cpu_op", "aten::to", t0 + 210, 115),
           launch("cudaMemcpyAsync", t0 + 215, 5),
           launch("cudaStreamSynchronize", t0 + 220, 102),
           launch("cudaEventQuery", t0 + 326, 2)]
    cc = next(c)
    ev += [launch("cudaLaunchKernel", t0 + 340, 5, k=cc), k("relu", t0 + 360, 20, cc),
           span("train.backward", t0 + 400, 300),
           X("cpu_op", "aten::zero_", t0 + 405, 10),
           X("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", t0 + 420, 200, tid=BW)]
    cc = next(c)
    ev += [launch("cudaLaunchKernel", t0 + 430, 5, tid=BW, k=cc), k("dgrad", t0 + 450, 200, cc),
           span("train.optimizer", t0 + 700, 200),
           X("cpu_op", "aten::add_", t0 + 710, 150)]
    cc = next(c)
    ev += [launch("cudaLaunchKernel", t0 + 720, 100, k=cc), k("adam", t0 + 830, 50, cc),
           span("train.log", t0 + 920, 30),
           X("cpu_op", "aten::stack", t0 + 925, 10)]
    cc = next(c)
    ev += [launch("cudaMemcpyAsync", t0 + 930, 5, k=cc), k("loss_copy", t0 + 940, 2, cc, "gpu_memcpy")]
    return ev


@pytest.fixture
def readings():
    events = [X("user_annotation", "portbench.window", 0, 2100)]
    events += step_events(0, 10) + step_events(1000, 20)
    # the window's closing synchronize, outside every step, returns in the tail
    events += [X("cuda_runtime", "cudaDeviceSynchronize", 2050, 5)]
    # a step outside the window does not count
    events += [span("train.step", 2500, 100), X("cuda_runtime", "cudaStreamSynchronize", 2510, 10)]
    return Readings(trace=Trace(events), steps_traced=2)


def test_self_time_leaves_out_child_spans_and_waits(readings):
    t = readings.trace
    step = _program.spans(t, "train.step")[0]
    assert _program.self_us(t, step) == pytest.approx(1000 - 102 - 2 - 95)
    # the loop: 1000 less the four parts (890 us), the log block counted in, no wait left
    assert loop_host_ms.read(readings) == pytest.approx(0.110)
    assert batch_host_ms.read(readings) == pytest.approx(0.090)
    # the optimizer's launch blocks 95 us beyond the median launch
    assert optimizer_host_ms.read(readings) == pytest.approx(0.105)


def test_model_counts_the_phase_kernels_and_the_autograd_thread(readings):
    # forward 300 us, its phase-kernel span counted in, less the sync (102) and the
    # event query (2); backward: the main thread's zero_ (10) and the autograd
    # thread's operator (200), not the main thread's wait for it
    assert model_host_ms.read(readings) == pytest.approx((300 - 104 + 10 + 200) / 1e3)


def test_syncs_count_waits_not_polls(readings):
    assert step_syncs.read(readings) == pytest.approx(1.0)
    assert _program.is_sync("cudaMemcpy") and _program.is_sync("cudaEventSynchronize")
    assert not _program.is_sync("cudaEventQuery") and not _program.is_sync("cudaMemcpyAsync")
    t = readings.trace
    pk = _program.spans(t, "ops.phase_kernels")[0]
    assert _program.runtime_in(t, *_program.bounds(pk), _program.is_sync) == 1


def test_launches_on_the_training_and_autograd_threads(readings):
    # main: 4 kernel launches and 2 async copies a step; the autograd thread: 1
    assert step_launches.read(readings) == pytest.approx(7.0)
    assert _program.is_launch("cuLaunchKernelEx") and _program.is_launch("cudaMemsetAsync")
    assert not _program.is_launch("cudaStreamSynchronize") and not _program.is_launch("cudaMemcpy")


def test_idle_share_of_the_gaps_a_sync_ends(readings):
    # each step's 40 us gap t0 + 320..360, in which the sync returns; not the
    # gaps without one, nor the tail where the window's synchronize returns
    assert idle_sync_pct.read(readings) == pytest.approx(100 * 80 / 2100)
    assert idle_sync_pct.read(readings) <= device_idle_pct.read(readings)


def test_readers_return_nothing_without_the_programs_spans():
    outside = Trace([X("user_annotation", "portbench.window", 0, 1000),
                     X("user_annotation", "portbench.step", 0, 900),
                     X("cpu_op", "aten::add", 10, 50),
                     X("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1),
                     X("kernel", "add", 30, 10, correlation=1),
                     X("cuda_runtime", "cudaStreamSynchronize", 40, 10)])
    for reader in NEW:
        assert reader.read(Readings(trace=outside, steps_traced=1)) is None
        assert reader.read(Readings()) is None
