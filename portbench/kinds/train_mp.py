"""Multi-path training traffic: one cell's run of `Trainer.train` on a
multi-path configuration (a MODEL_PATH of n_o meshes: the shared encoder
and the bank of n_o decoders), as `train.py` runs the template's.

Set-up: n_o seeded procedural meshes written once, the configuration
parsed by the port (which must know a list of meshes: a program without
the multi-path model stops here, before any render), each object's pool
loaded (or, on a checkout's first run, rendered by the port's `Dataset`
for that object alone and cached under `portbench/_data/`), seeded
backgrounds, the stratified `DeviceDataset`, the `Trainer`, and its
weights set from the reference's seeded weights (`reference/multipath.py`).
Then, as `train.py`: the checked steps, the warm-up, with tracing on the
traced stretch (read by `metrics/_bank.BankTrace` too), the window, and
last the reference following the checked steps. The comparison holds
each object's decoder to its own (`multipath.per_object`).
"""

from __future__ import annotations

import configparser
import gc
import math
import os
import tempfile
import threading
import time
from typing import Dict

import numpy as np
import torch

from ..metrics import _flops_mp
from ..metrics._bank import BankTrace
from ..metrics._trace import SPAN_PREFIX
from ..readings import Readings
from ..reference import augment, compare, model, multipath
from . import train


def pool_dir(config: dict, data_dir: str) -> str:
    return os.path.join(data_dir, f"multipath-seed-{config['pool']['render_seed']}")


def ensure_meshes(config: dict, data_dir: str):
    """The pool's procedural meshes, one a seed of `pool.mesh_seeds`, each
    written once."""
    from augmentedautoencoder_torch.renderer.procedural import make_textured_asymmetric, save_ply

    pool = config["pool"]
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for seed in pool["mesh_seeds"]:
        path = os.path.join(data_dir, f"mesh-s{pool['subdivisions']}-r{pool['radius_mm']:g}-seed{seed}.ply")
        if not os.path.exists(path):
            mesh = make_textured_asymmetric(subdivisions=pool["subdivisions"], radius=pool["radius_mm"], seed=seed)
            save_ply(mesh, path + ".tmp.ply")
            os.replace(path + ".tmp.ply", path)
        paths.append(path)
    return paths


def parse(config: dict, traffic: dict, data_dir: str):
    """(cfg, pool directory): the configuration as the port parses it, its
    MODEL_PATH the list of meshes, at the traffic's batch."""
    from augmentedautoencoder_torch.config import load_train_config

    data_dir = pool_dir(config, data_dir)
    meshes = ensure_meshes(config, data_dir)
    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    cp.read_string(train.cfg_text(config["cfg"], MODEL_PATH=repr(meshes), BATCH_SIZE=traffic["batch_size"]))
    np.random.seed(config["pool"]["parse_seed"])
    cfg = load_train_config(cp)
    if cfg.n_objects != len(meshes):
        raise RuntimeError(f"the port reads {cfg.n_objects} objects from a MODEL_PATH of {len(meshes)} meshes")
    return cfg, data_dir


def load_pool(config: dict, cfg, data_dir: str):
    """(train_x, mask_x, train_y, noof_obj_pixels, bg): the objects' pools
    stacked in object order, object o rendered from RandomState([render
    seed, o]) by the port's `Dataset` of that object alone, and seeded
    backgrounds."""
    from augmentedautoencoder_torch import factory

    pool = config["pool"]
    parts = []
    for o in range(cfg.n_objects):
        dataset = factory.build_dataset(data_dir, cfg.for_object(o))
        dataset.get_training_images(data_dir, np.random.RandomState([pool["render_seed"], o]), progress=False)
        parts.append((dataset.train_x, dataset.mask_x, dataset.train_y, dataset.noof_obj_pixels))
    rng = np.random.RandomState(pool["background_seed"])
    bg = rng.randint(0, 256, (cfg.noof_bg_imgs,) + tuple(cfg.shape), dtype=np.uint8)
    return tuple(np.concatenate(a) for a in zip(*parts)) + (bg,)


def build(config: dict, traffic: dict, seed: int, device, data_dir: str, pool=None):
    """(trainer, recorder, pool arrays): the program set up for the run, its
    weights those of `multipath.make_weights` from `seed`."""
    from augmentedautoencoder_torch.data.pipeline import DeviceDataset
    from augmentedautoencoder_torch.training import Trainer

    cfg, data_dir = parse(config, traffic, data_dir)
    pool = pool or load_pool(config, cfg, data_dir)
    train_x, mask_x, train_y, n_obj, bg = pool
    ds = DeviceDataset(cfg, train_x, mask_x, train_y, bg, n_obj, device=device, n_objects=cfg.n_objects)
    recorder = train._Recorder()
    trainer = Trainer(cfg, ds, seed=seed, metric_writer=recorder)
    weights = multipath.make_weights(model.Arch(config["cfg"]), cfg.n_objects, seed, device)
    params = dict(trainer.model.named_parameters())
    if {k: tuple(v.shape) for k, v in params.items()} != {k: tuple(v.shape) for k, v in weights.items()}:
        raise RuntimeError(f"the port's parameters {sorted(params)} are not the reference's {sorted(weights)}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])
    del weights
    return trainer, recorder, pool


def n_objects_of(config: dict) -> int:
    return len(config["pool"]["mesh_seeds"])


def step_ops(config: dict, traffic: dict):
    arch = model.Arch(config["cfg"])
    return _flops_mp.step_ops(arch.h, arch.w, arch.c, arch.filters, arch.k_enc, arch.k_dec, arch.latent,
                              n_objects_of(config), traffic["batch_size"], train.precision_of(config))


def traced_stretch(trainer, steps: int, log_every: int, sync) -> BankTrace:
    """`steps` of the loop under torch.profiler inside `portbench.window`,
    as `train.traced_stretch`, read as a `BankTrace`."""
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
        return BankTrace.load(path)
    finally:
        os.remove(path)


def per_object(rec: dict, n_objects: int) -> dict:
    """A record (`compare`'s) with every decoder leaf split into its
    objects' leaves (`multipath.per_object`)."""
    return {**rec, **{k: multipath.per_object(rec[k], n_objects) for k in ("grad", "p0", "pN")}}


def compare_objects(rec: dict, ref: dict, n_objects: int) -> Dict[str, float]:
    """`compare.compare` with every decoder held to its own object's leaves."""
    return compare.compare(per_object(rec, n_objects), per_object(ref, n_objects))


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device, data_dir: str,
        limits: Dict[str, float], t_start: float) -> dict:
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    marks = {"imported": time.perf_counter() - t_start}
    trainer, recorder, pool_np = build(config, traffic, seed, device, data_dir)
    marks["built"] = time.perf_counter() - t_start
    if trace:
        train.install_spans(trainer)
    rec = train.check_steps(trainer, recorder, traffic["check_steps"])
    marks["checked"] = time.perf_counter() - t_start
    log_every = traffic["log_every"]
    trainer.train(num_iter=trainer.step + traffic["warmup_steps"], log_every=log_every, progress=False)
    sync()
    marks["warm"] = time.perf_counter() - t_start
    readings = Readings(precision=train.precision_of(config), step_ops=step_ops(config, traffic))
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
    failed = sum(1 for row in recorder.rows.values() if not all(math.isfinite(v) for v in row.values()))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the reference, once the program's state is freed
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = compare_objects(rec, reference(config, traffic, seed, device, pool_np), n_objects_of(config))
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
    n_objects = n_objects_of(config)
    chain = augment.parse_code(config["cfg"]["Augmentation"]["CODE"], config["pool"]["parse_seed"])
    train_x, mask_x, train_y, _, bg = pool_np
    pool = augment.pool_on(device, train_x, mask_x, train_y, bg)
    weights = multipath.make_weights(arch, n_objects, seed, device)
    ref = multipath.reference_record(arch, n_objects, chain, pool, weights, seed, traffic["batch_size"],
                                     traffic["check_steps"], lowp)
    return {k: train._host(v) for k, v in ref.items()}


breakdown = train.breakdown
