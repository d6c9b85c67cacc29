"""Training traffic: one cell's run of `Trainer.train`, the port's
training loop, on the cell's configuration and training traffic.

Set-up: the configuration parsed by the port, the render pool loaded (or,
on a checkout's first run, rendered by the port's `Dataset` and cached
under `portbench/_data/`), seeded backgrounds, the `DeviceDataset`, the
`Trainer`, and its weights set from the run's seed. The first
`check_steps` steps run through `Trainer.train` with the losses logged
each step, and the first gradient and the parameters are read from the
program's state; then `warmup_steps` more warm the window's shapes. With
tracing on, `trace_steps` more run under torch.profiler. Then the window:
`Trainer.train` back to back until the window's seconds are up, its
losses read only at the trainer's deferred flushes, closed by a
synchronize after the last step. Last, with the program's state freed,
the reference follows the checked steps and the comparison decides
`correct`.
"""

from __future__ import annotations

import configparser
import gc
import math
import os
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from ..metrics import _flops
from ..metrics._trace import SPAN_PREFIX, Trace
from ..readings import Readings
from ..reference import augment, compare, model


class _Recorder:
    """The trainer's metric writer: the logged losses, kept in memory."""

    def __init__(self):
        self.rows: Dict[int, Dict[str, float]] = {}

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        self.rows[int(step)] = dict(scalars)


def cfg_text(sections: Dict[str, Dict[str, str]], **overrides) -> str:
    """The .cfg text of the configuration's sections, `overrides` (KEY=value)
    put in place of their keys."""
    lines = []
    for section, keys in sections.items():
        lines.append(f"[{section}]")
        for key, value in keys.items():
            lines.append(f"{key}: {overrides.get(key, value)}")
    return "\n".join(lines) + "\n"


def precision_of(config: dict) -> str:
    return config["cfg"].get("Training", {}).get("PRECISION", "float32")


def load_pool(config: dict, cfg, data_dir: str):
    """(train_x, mask_x, train_y, noof_obj_pixels, bg) of the configuration:
    the port's renders of the procedural mesh from the pool's seed, loaded
    from their cache after a checkout's first run, and seeded backgrounds."""
    from augmentedautoencoder_torch import factory

    pool = config["pool"]
    dataset = factory.build_dataset(data_dir, cfg)
    dataset.get_training_images(data_dir, np.random.RandomState(pool["render_seed"]), progress=False)
    rng = np.random.RandomState(pool["background_seed"])
    bg = rng.randint(0, 256, (cfg.noof_bg_imgs,) + tuple(cfg.shape), dtype=np.uint8)
    return dataset.train_x, dataset.mask_x, dataset.train_y, dataset.noof_obj_pixels, bg


def pool_dir(config: dict, data_dir: str) -> str:
    """The directory of the configuration's pool: one per render seed, so
    configurations that render alike share it (the port keys its cache on
    the Dataset and Paths keys, not on the seed)."""
    return os.path.join(data_dir, f"render-seed-{config['pool']['render_seed']}")


def ensure_mesh(config: dict, data_dir: str) -> str:
    """The procedural mesh of the pool, written once."""
    from augmentedautoencoder_torch.renderer.procedural import make_textured_asymmetric, save_ply

    pool = config["pool"]
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, f"mesh-s{pool['subdivisions']}-r{pool['radius_mm']:g}.ply")
    if not os.path.exists(path):
        tmp = path + ".tmp.ply"
        save_ply(make_textured_asymmetric(subdivisions=pool["subdivisions"], radius=pool["radius_mm"]), tmp)
        os.replace(tmp, path)
    return path


def parse(config: dict, traffic: dict, data_dir: str):
    """(cfg, pool directory): the configuration as the port parses it, at
    the traffic's batch, its mesh written once."""
    from augmentedautoencoder_torch.config import load_train_config

    data_dir = pool_dir(config, data_dir)
    mesh = ensure_mesh(config, data_dir)
    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    cp.read_string(cfg_text(config["cfg"], MODEL_PATH=mesh, BATCH_SIZE=traffic["batch_size"]))
    # the CODE's np.random.rand() is drawn when it is parsed
    np.random.seed(config["pool"]["parse_seed"])
    return load_train_config(cp), data_dir


def build(config: dict, traffic: dict, seed: int, device, data_dir: str, pool=None):
    """(trainer, recorder, pool arrays): the program set up for the run, its
    weights those of `model.make_weights` from `seed`; `pool`, the arrays of
    an earlier call, is used as it is."""
    from augmentedautoencoder_torch.data.pipeline import DeviceDataset
    from augmentedautoencoder_torch.training import Trainer

    cfg, data_dir = parse(config, traffic, data_dir)
    pool = pool or load_pool(config, cfg, data_dir)
    train_x, mask_x, train_y, n_obj, bg = pool
    ds = DeviceDataset(cfg, train_x, mask_x, train_y, bg, n_obj, device=device)
    recorder = _Recorder()
    trainer = Trainer(cfg, ds, seed=seed, metric_writer=recorder)
    weights = model.make_weights(model.Arch(config["cfg"]), seed, device)
    params = dict(trainer.model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(f"the port's parameters {sorted(params)} are not the reference's {sorted(weights)}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])
    return trainer, recorder, pool


def _spanned(name: str, fn):
    def call(*args, **kwargs):
        with torch.profiler.record_function(SPAN_PREFIX + name):
            return fn(*args, **kwargs)

    return call


def install_spans(trainer) -> None:
    """Spans around the calls into each layer, on the instances the step
    calls: the step, the batch, the model's forward and the optimizer."""
    trainer.step_fn = _spanned("step", trainer.step_fn)
    trainer.dataset.sample_batch = _spanned("sample_batch", trainer.dataset.sample_batch)
    trainer.model.forward = _spanned("forward", trainer.model.forward)
    trainer.optimizer.step = _spanned("optimizer", trainer.optimizer.step)


def first_moment(optimizer) -> Dict[str, torch.Tensor]:
    """Adam's first moment of every parameter, from the port's optimizer state."""
    return optimizer.state_dict()["slots"]["mu"]


def check_steps(trainer, recorder, steps: int) -> dict:
    """The program's record of its first `steps` steps, through `Trainer.train`:
    the losses logged each step, the first gradient as the optimizer got it,
    and the parameters before and after (on the host)."""
    p0 = {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.named_parameters()}
    trainer.train(num_iter=1, log_every=1, progress=False)
    grad = {k: v / (1.0 - model.B1) for k, v in first_moment(trainer.optimizer).items()}
    trainer.train(num_iter=steps, log_every=1, progress=False)
    pN = {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.named_parameters()}
    losses = [recorder.rows[i + 1]["total_loss"] for i in range(steps)]
    return {"losses": losses, "grad": grad, "p0": p0, "pN": pN}


def traced_stretch(trainer, steps: int, log_every: int, sync) -> Trace:
    """`steps` of the loop under torch.profiler, inside the span
    `portbench.window`, which opens and closes on an idle device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        sync()
        with torch.profiler.record_function(SPAN_PREFIX + "window"):
            trainer.train(num_iter=trainer.step + steps, log_every=log_every, progress=False)
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Trace.load(path)
    finally:
        os.remove(path)


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device, data_dir: str,
        limits: Dict[str, float], t_start: float) -> dict:
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    precision = precision_of(config)
    marks = {"imported": time.perf_counter() - t_start}
    trainer, recorder, pool_np = build(config, traffic, seed, device, data_dir)
    marks["built"] = time.perf_counter() - t_start
    if trace:
        install_spans(trainer)
    rec = check_steps(trainer, recorder, traffic["check_steps"])
    marks["checked"] = time.perf_counter() - t_start
    log_every = traffic["log_every"]
    trainer.train(num_iter=trainer.step + traffic["warmup_steps"], log_every=log_every, progress=False)
    sync()
    marks["warm"] = time.perf_counter() - t_start
    arch = model.Arch(config["cfg"])
    readings = Readings(precision=precision, step_ops=_flops.step_ops(
        arch.h, arch.w, arch.c, arch.filters, arch.k_enc, arch.k_dec, arch.latent, traffic["batch_size"], precision))
    if trace:
        readings.trace = traced_stretch(trainer, traffic["trace_steps"], log_every, sync)
        readings.steps_traced = traffic["trace_steps"]

    # the window
    recorder.rows.clear()
    setup_s = time.perf_counter() - t_start
    start = trainer.step
    timer = threading.Timer(seconds, trainer.request_stop)
    t0 = time.perf_counter()
    timer.start()
    try:
        trainer.train(num_iter=2**62, log_every=log_every, progress=False)
        sync()
    finally:
        timer.cancel()
        timer.join()
    window_s = time.perf_counter() - t0
    steps = trainer.step - start
    readings.window_steps, readings.window_s = steps, window_s
    logged = list(recorder.rows.values())
    failed = sum(1 for row in logged if not all(math.isfinite(v) for v in row.values()))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the reference, once the program's state is freed
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = compare.compare(rec, reference(config, traffic, seed, device, pool_np))
    ref_s = time.perf_counter() - t_ref
    return {
        "correct": compare.judge(numbers, limits) and failed == 0,
        "attempted": steps,
        "failed": failed,
        "end_to_end": {"train_samples_per_s": steps * traffic["batch_size"] / window_s, "setup_s": setup_s},
        "readings": readings,
        "memory_peak_bytes": int(peak),
        "checks": {k: {"value": numbers[k], "limit": v} for k, v in limits.items()},
        "notes": {"setup_marks_s": marks, "window_s": window_s, "steps": steps, "reference_s": ref_s},
    }


def reference(config: dict, traffic: dict, seed: int, device, pool_np, lowp=None) -> dict:
    """The reference's record of the checked steps (on the host), from the
    run's weights, pool and draws; with `lowp`, the control's."""
    arch = model.Arch(config["cfg"])
    chain = augment.parse_code(config["cfg"]["Augmentation"]["CODE"], config["pool"]["parse_seed"])
    train_x, mask_x, train_y, _, bg = pool_np
    pool = augment.pool_on(device, train_x, mask_x, train_y, bg)
    weights = model.make_weights(arch, seed, device)
    ref = compare.reference_record(arch, chain, pool, weights, seed, traffic["batch_size"], traffic["check_steps"],
                                   lowp)
    return {k: _host(v) for k, v in ref.items()}


def _host(v):
    if isinstance(v, dict):
        return {k: t.detach().to("cpu", copy=True) for k, t in v.items()}
    return v


def breakdown(t: Trace, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time, by layer, operator and
    kernel, and the idle gaps by what the host was issuing when the device
    resumed, each summed over the traced stretch, in seconds."""
    ops: Dict[str, float] = {}
    for o in t.ops:
        key = f"{o.layer} | {o.op} | {o.name[:80]}"
        ops[key] = ops.get(key, 0.0) + o.dur / 1e6
    gaps: Dict[str, float] = {}
    for (s, e), nxt in t.gaps():
        key = "window end" if nxt is None else f"{nxt.layer} | {nxt.op}"
        gaps[key] = gaps.get(key, 0.0) + (e - s) / 1e6
    order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": order(ops), "idle_gaps": order(gaps)}
