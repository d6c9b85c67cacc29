"""Multi-card cells on the CPU: two ranks of `kinds/train_ddp.py` over gloo
at a tiny width (the same window on both, `correct`, and `correct` false
with the timed path broken underneath), the launcher's supervision of its
ranks and its assembly of their records, the refusal of too few cards,
and the readers of the communication kernels on hand-built traces."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import ranks, run
from portbench.metrics import (_params, allreduce_roofline, comm_device_ms, comm_exposed_ms,
                               model_step_device_ms)
from portbench.metrics._trace import Trace, intersection
from portbench.readings import Readings

from . import tiny
from .test_portbench_trace import X, step_events

CELL = "train_f32_ddp4_b64"
TRAFFIC = dict(tiny.TRAFFIC, kind="train_ddp")


# ------------------------------------------------------------------ two ranks of the kind
def _plant(fault):
    """The timed path broken underneath, in this rank's process."""
    from augmentedautoencoder_torch.data.pipeline import DeviceDataset
    from augmentedautoencoder_torch.training.state import OptaxOptimizer

    if fault == "half_batch":
        whole = DeviceDataset.sample_batch
        DeviceDataset.sample_batch = lambda self, gen, b, shard=(0, 1): tuple(
            t[: t.shape[0] // 2] for t in whole(self, gen, b, shard))
    elif fault == "unchanged":
        OptaxOptimizer.step = lambda self: None
    elif fault == "no_allreduce":
        ddp = torch.nn.parallel.DistributedDataParallel
        init = ddp.__init__

        def no_sync_init(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self.require_backward_grad_sync = False

        ddp.__init__ = no_sync_init


def _rank(device, fault, trace):
    """One rank's run at the tiny width on the random pool."""
    from portbench.kinds import train, train_ddp

    train.load_pool = tiny.random_pool
    train.ensure_mesh = lambda config, data_dir: os.path.join(data_dir, "unused.ply")
    _plant(fault)
    out = train_ddp.run(tiny.config(), TRAFFIC, 3_000_000_041, 0.5, trace, device, "/nonexistent",
                        tiny.limits(CELL), time.monotonic())
    r = out["readings"]
    return {"correct": out["correct"], "attempted": out["attempted"], "window_steps": r.window_steps,
            "checks": out["checks"], "traced": r.trace is not None, "grad_bytes": r.grad_bytes,
            "batch": sum(o["flops"] for o in r.step_ops)}


def _two_ranks(fault=None, trace=False):
    from augmentedautoencoder_torch.parallel.dryrun import run_ranks

    return run_ranks(_rank, 2, "cpu", fault, trace, timeout=300)


def test_two_ranks_run_one_window_and_are_correct():
    first, second = _two_ranks(trace=True)
    assert first["correct"], first["checks"]
    assert first["attempted"] > 0 and first["attempted"] == second["attempted"]
    assert first["window_steps"] == second["window_steps"] == first["attempted"]
    assert first["checks"]["ranks_unlike"]["value"] == 0
    # only rank 0 traces; each rank's operations are those of its slice of the batch
    assert first["traced"] and not second["traced"]
    assert first["batch"] == sum(o["flops"] for o in _flops_of(tiny.TRAFFIC["batch_size"] // 2))
    assert first["grad_bytes"] == 4 * _params.param_count(32, 32, 3, [8, 16], 5, 5, 8)


def _flops_of(batch):
    from portbench.metrics import _flops

    return _flops.step_ops(32, 32, 3, [8, 16], 5, 5, 8, batch, "float32")


@pytest.mark.parametrize("fault", ["half_batch", "unchanged", "no_allreduce"])
def test_broken_timed_path_over_ranks_is_not_correct(fault):
    first, second = _two_ranks(fault)
    assert not first["correct"], first["checks"]
    assert first["attempted"] == second["attempted"] > 0
    if fault == "no_allreduce":
        assert first["checks"]["ranks_unlike"]["value"] == 1


def _calibrate_rank(device):
    from portbench import calibrate
    from portbench.kinds import train

    train.load_pool = tiny.random_pool
    train.ensure_mesh = lambda config, data_dir: os.path.join(data_dir, "unused.ply")
    seed = 3_000_000_059
    return calibrate.readings(CELL, [seed], [seed], [seed], device, tiny.config(), TRAFFIC, "/nonexistent")


def test_calibration_over_two_ranks():
    """`calibrate.readings` over ranks: rank 0 reads, the sound run within
    the cell's limits, the control and the three faults outside them."""
    from augmentedautoencoder_torch.parallel.dryrun import run_ranks
    from portbench.reference import compare

    rows, others = run_ranks(_calibrate_rank, 2, "cpu", timeout=300)
    assert others == []
    judged = {r["kind"]: compare.judge(r, tiny.limits(CELL)) for r in rows}
    assert judged == {"sound": True, "control": False, "half_batch": False, "unchanged": False,
                      "no_allreduce": False}, rows
    assert {r["kind"]: r.get("ranks_unlike") for r in rows if r["kind"] != "control"} == {
        "sound": 0, "half_batch": 0, "unchanged": 0, "no_allreduce": 1}


def test_control_fails_the_cells_limits(monkeypatch):
    """The TF32 control against the reference fails the four-card cell's
    limits (its reference is the one-card cell's: the global batch)."""
    from portbench.kinds import train
    from portbench.reference import compare, lowp

    tiny.patch_pool(monkeypatch)
    config = tiny.config()
    seed = 3_000_000_043
    _, _, pool = train.build(config, tiny.TRAFFIC, seed, "cpu", "/nonexistent")
    ref = train.reference(config, tiny.TRAFFIC, seed, "cpu", pool)
    control = train.reference(config, tiny.TRAFFIC, seed, "cpu", pool,
                              lowp.operand_rounding(lowp.CONTROL_OF["float32"]))
    assert not compare.judge(compare.compare(control, ref), tiny.limits(CELL))


# ------------------------------------------------------------------ the launcher
def _card(uuid, peak=100, power=700.0, kind="NVIDIA H100 80GB HBM3"):
    return {"uuid": uuid, "kind": kind, "memory_peak_bytes": peak, "power_limit_w": power}


def _records(uuids, peaks=None, powers=None, forbidden=()):
    peaks = peaks or [100] * len(uuids)
    powers = powers or [700.0] * len(uuids)
    out = [{"rank": r, "card": _card(u, p, w), "forbidden": list(forbidden) if r == 2 else []}
           for r, (u, p, w) in enumerate(zip(uuids, peaks, powers))]
    out[0]["result"] = {"correct": True, "attempted": 5, "failed": 0, "metrics": {},
                        "device": {"busy_s": 1.5, "window_s": 2.0}, "checks": {}}
    return out


def test_records_assemble_into_one_result():
    recs = _records(["a", "b", "c", "d"], peaks=[5, 9, 7, 6], powers=[700.0, 650.0, 700.0, 700.0])
    result, why = ranks.assemble(list(reversed(recs)), 4)
    assert why is None
    assert result["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
                                "memory_peak_bytes": 9, "power_limit_w": 700.0, "power_limit_min_w": 650.0,
                                "busy_s": 1.5, "window_s": 2.0}
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("case", ["one_card", "forbidden", "missing"])
def test_records_that_refuse_the_run(case):
    if case == "one_card":
        recs, world = _records(["a", "b", "b", "d"]), 4
    elif case == "forbidden":
        recs, world = _records(["a", "b", "c", "d"], forbidden=["jax"]), 4
    else:
        recs, world = _records(["a", "b", "c"]), 4
    result, why = ranks.assemble(recs, world)
    assert result is None and why


def _py(code):
    return [sys.executable, "-c", code]


@pytest.mark.parametrize("case", ["all_done", "exits_non_zero", "killed", "hangs"])
def test_supervision_of_the_ranks(case, tmp_path):
    """Every rank ended on return; 1 as soon as one fails or at the limit."""
    pid_file = tmp_path / "pids"
    sleeper = _py(f"import os, time; open({str(pid_file)!r}, 'a').write(f'{{os.getpid()}}\\n'); time.sleep(120)")
    first = {"all_done": _py("pass"), "exits_non_zero": _py("import sys; sys.exit(3)"),
             "killed": _py("import os, signal; os.kill(os.getpid(), signal.SIGKILL)"), "hangs": sleeper}[case]
    others = [_py("pass")] * 3 if case == "all_done" else [sleeper] * 3
    logs = []
    t0 = time.monotonic()
    code = ranks.supervise([first] + others, [dict(os.environ)] * 4, 5.0 if case == "hangs" else 60.0, logs.append)
    assert time.monotonic() - t0 < 30
    assert code == (0 if case == "all_done" else 1)
    assert bool(logs) == (case != "all_done")
    if pid_file.exists():
        for pid in map(int, pid_file.read_text().split()):
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)


def test_rank_environment_is_torchruns():
    env = ranks.rank_env({"PATH": "/bin"}, 2, 4, 29500, {"X": "1"})
    assert {k: env[k] for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "X")} == {
        "WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500",
        "X": "1"}


def test_too_few_cards_exit_2_with_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert run.main(["--workload", CELL, "--seed", "5000000001", "--seconds", "1"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "needs 4 CUDA device(s), found 2" in captured.err


def test_the_command_without_a_card_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed", "5000000003",
                           "--seconds", "1"], cwd=tiny.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""


# ------------------------------------------------------------------ the readers of communication
def _comm_trace(with_comm=True):
    """Two steps of the trace tests' hand-built step; in each, an NCCL kernel
    launched from the backward that its kernel overlaps for 200 us of 400,
    and one under the optimizer's kernel (20 us, wholly overlapped)."""
    events = [X("user_annotation", "portbench.window", 0, 2000)]
    events += step_events(0, 10) + step_events(1000, 20)
    if with_comm:
        for t0, corr in ((0, 50), (1000, 60)):
            events += [X("cpu_op", "nccl:all_reduce", t0 + 350, 20, tid=2),
                       X("cuda_runtime", "cudaLaunchKernel", t0 + 355, 5, tid=2, correlation=corr),
                       X("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", t0 + 500, 400, correlation=corr),
                       X("cpu_op", "nccl:all_reduce", t0 + 925, 10),
                       X("cuda_runtime", "cudaLaunchKernel", t0 + 926, 2, correlation=corr + 1),
                       X("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", t0 + 930, 20, correlation=corr + 1)]
    return Trace(events)


def test_intersection():
    assert intersection([(0, 10), (20, 30)], [(5, 25)]) == [(5, 10), (20, 25)]
    assert intersection([(0, 10)], [(10, 20)]) == []


def test_comm_readers_on_a_hand_built_trace():
    r = Readings(trace=_comm_trace(), steps_traced=2, grad_bytes=int(450e9 * 420e-6 / 2))
    # a step: 400 + 20 us of NCCL kernels; conv_dgrad (400-700) overlaps the first from 500
    # to 700 and nothing from 700 to 900, adam_update (920-970) the second wholly
    assert comm_device_ms.read(r) == pytest.approx(0.420)
    assert comm_exposed_ms.read(r) == pytest.approx(0.200)
    assert 0 <= comm_exposed_ms.read(r) <= comm_device_ms.read(r)
    assert allreduce_roofline.read(r) == pytest.approx(50.0)
    # the model step leaves the communication out and reads as without it
    assert model_step_device_ms.read(r) == pytest.approx(model_step_device_ms.read(
        Readings(trace=_comm_trace(False), steps_traced=2))) == pytest.approx((200 + 100 + 300) / 1e3)


def test_comm_readers_read_nothing_without_nccl_kernels():
    r = Readings(trace=_comm_trace(False), steps_traced=2, grad_bytes=1000)
    for reader in (comm_device_ms, comm_exposed_ms, allreduce_roofline):
        assert reader.read(r) is None
        assert reader.read(Readings()) is None
    assert allreduce_roofline.read(Readings(trace=_comm_trace(), steps_traced=2)) is None


def test_gradient_bytes_of_the_template():
    """The parameter count from the template's shapes against the port's
    model (meta tensors) and the reference's leaves: 29.74 M, 119 MB of
    float32 gradients."""
    from augmentedautoencoder_torch.config import load_train_config
    from augmentedautoencoder_torch.models import AAE

    from portbench.reference import model

    cfg = load_train_config(f"{tiny.ROOT}/augmentedautoencoder_torch/cfg_templates/train_template.cfg")
    with torch.device("meta"):
        port = AAE.from_config(cfg, train=True)
    n = sum(p.numel() for p in port.parameters() if p.requires_grad)
    with open(os.path.join(tiny.ROOT, "portbench", "configs", "aae_template.json")) as fh:
        arch = model.Arch(json.load(fh)["cfg"])
    assert n == sum(torch.Size(shape).numel() for _, shape, _ in arch.leaves())
    assert _params.param_count(128, 128, 3, [128, 256, 512, 512], 5, 5, 128) == n == 29_742_211
    assert _params.grad_bytes(128, 128, 3, [128, 256, 512, 512], 5, 5, 128) == 4 * n


# ------------------------------------------------------------------ on four cards
@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("fewer than four CUDA devices here: run on the four-card machine")


@pytest.mark.cuda
def test_a_short_run_of_the_four_card_cell(four_cards):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed", "3000000047",
                           "--seconds", "2", "--trace", "0"], cwd=tiny.ROOT, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 4
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}


@pytest.mark.cuda
def test_sound_control_and_faults_on_four_cards(four_cards, tmp_path):
    """One seed at the cell's own size, one rank a card under torchrun: the
    program within the cell's limits; the control and the three planted
    faults outside them."""
    from portbench.reference import compare

    seed, out = "3000000053", tmp_path / "cal.json"
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=4",
                           "portbench/calibrate.py", "--workload", CELL, "--seeds", seed, "--control-seeds", seed,
                           "--fault-seeds", seed, "--out", str(out)], cwd=tiny.ROOT, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = json.loads(out.read_text())["rows"]
    judged = {r["kind"]: compare.judge(r, tiny.limits(CELL)) for r in rows}
    assert judged == {"sound": True, "control": False, "half_batch": False, "unchanged": False,
                      "no_allreduce": False}, rows
