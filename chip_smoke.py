#!/usr/bin/env python3
"""Chip smoke test of augmentedautoencoder_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA toolkit) and this checkout; no network,
no jax. Phases, each fatal on failure:

  1. device   -- require CUDA, print the card's name and power limit, turn
                 TF32 off for the f32 arms;
  2. build    -- compile csrc/*.cu with nvcc (sm_90a), print the seconds and
                 the ptxas resource report;
  3. kernels  -- each CUDA kernel against its plain PyTorch version on seeded
                 tensors at the serving shapes (92,232-row codebook; a
                 (30, 94,208, 128) slab in f32 and bf16; k in {1, 8, 32};
                 stride in {1, 36}; duplicated-row ties; masked rows), with
                 CUDA-event times of both;
  4. serving  -- a 3-class workspace at the full width of
                 cfg_templates/train_template.cfg (128x128x3, filters
                 [128, 256, 512, 512], latent 128, 92,232-row codebooks) with
                 seeded weights and codebooks in which the codes of the
                 frames' crops are planted at known indices; 8 frames of 24
                 detections through PoseServer.process_stream in two recipes
                 (f32 top-1; bf16 topk_aggregate 8) and one
                 AePoseEstimator.process frame. Checks the planted poses, one
                 frame per recipe against the same server on the CPU, and
                 that every kernel was launched by this main path.

The last lines are the kernels' JSON line, the nvidia-smi line, and
{"ok": true, "device": {...}}. Exits non-zero, without that line, on any
failure, without a GPU, or without the rest of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TEMPLATE = os.path.join(REPO, "augmentedautoencoder_tpu", "cfg_templates", "train_template.cfg")
KERNEL_SOURCE = "augmentedautoencoder_torch/csrc/codebook_query.cu"
MARGIN = 1e-5  # indices must agree where the plain ranking is not this close
VAL_TOL = 1e-5  # |kernel - plain| for every returned score


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------------ phase 1
def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
    return smi


# ------------------------------------------------------------------ phase 2
def build_phase():
    from augmentedautoencoder_torch.ops import _cuda

    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(path, REPO)}")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")


# ------------------------------------------------------------------ phase 3
def time_pair(kernel_fn, plain_fn, reps=20, warmup=3):
    """Median ms per launch of a kernel and its plain version by CUDA
    events, `reps` launches each after warm-up, in turns (plain, kernel,
    kernel, plain), with the 50 MB L2 flushed before every launch: serving
    reads each class's plane once per frame, after the encoder has swept
    the cache. The last result of each is read back to the host."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")  # 256 MB
    for _ in range(warmup):
        kernel_fn()
        plain_fn()
    fns = {"kernel": kernel_fn, "plain": plain_fn}
    runs = {"kernel": [], "plain": []}
    last = {}
    for tag in ("plain", "kernel", "kernel", "plain") * (reps // 2):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        last[tag] = fns[tag]()
        end.record()
        runs[tag].append((start, end))
    torch.cuda.synchronize()
    for out in last.values():
        [o.cpu() for o in out]

    def median(pairs):
        ms = sorted(s.elapsed_time(e) for s, e in pairs)
        return ms[len(ms) // 2]

    return median(runs["kernel"]), median(runs["plain"])


def compare_topk(name, got, plain, ext_vals):
    """Kernel (vals, idcs) vs plain (vals, idcs), both (B, k). ext_vals is the
    plain ranking's top-(k+1) values: an index must agree wherever its
    score is more than MARGIN from both neighbours. Returns max |dv|."""
    import torch

    gv, gi = (t.reshape(t.shape[0], -1).cpu() for t in got)
    pv, pi = (t.reshape(t.shape[0], -1).cpu() for t in plain)
    ext = ext_vals.cpu()
    k = pv.shape[1]
    err = float((gv - pv).abs().max())
    if not err <= VAL_TOL:
        raise AssertionError(f"{name}: values differ by {err} > {VAL_TOL}")
    prev_gap = torch.cat([torch.full_like(ext[:, :1], float("inf")), ext[:, :k] - ext[:, 1 : k + 1]], dim=1)
    clear = (prev_gap[:, :k] > MARGIN) & (prev_gap[:, 1 : k + 1] > MARGIN)
    bad = clear & (gi != pi.to(gi.dtype))
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} indices differ at clear margins")
    return err


def kernel_phase(n_rows=92_232, n_obj=30, d=128, objs=(0, 17, 29), bs=(8, 64), reps=20):
    import torch

    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.ops.nn_query import l2_normalize, topk_lowest_index

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_pad = -(-n_rows // 2048) * 2048
    errs = {"cosine_top1_cuda": 0.0, "grouped_codebook_top1": 0.0, "grouped_codebook_topk": 0.0}
    times = []

    def rows(n):
        return l2_normalize(torch.randn((n, d), generator=gen, device=dev))

    def ranking(z, plane, n_valid, stride, k):
        """The plain masked scores' top-(k+1) values, for the margin rule."""
        s = l2_normalize(z.float()).to(plane.dtype).float() @ plane.float().T
        col = torch.arange(s.shape[1], device=dev)
        valid = (col < n_valid) & ((col % stride) == 0)
        s = torch.where(valid[None], s, torch.full_like(s, -2.0))
        return topk_lowest_index(s, k + 1)[0]

    # -- B3: single-codebook top-1 (estimator path)
    cb32 = rows(n_rows)
    for dtype in (torch.float32, torch.bfloat16):
        cb = cb32.to(dtype)
        for b in bs:
            z = torch.randn((b, d), generator=gen, device=dev)
            got = nq.cosine_top1_cuda(z, cb)
            plain = nq.cosine_top1_plain(z, cb)
            name = f"B3 cosine_top1 N={n_rows} B={b} {str(dtype)[6:]}"
            err = compare_topk(name, got, plain, ranking(z, cb, n_rows, 1, 1))
            errs["cosine_top1_cuda"] = max(errs["cosine_top1_cuda"], err)
            t_k, t_p = time_pair(lambda: nq.cosine_top1_cuda(z, cb),
                                 lambda: nq.cosine_top1_plain(z, cb), reps)
            times.append((name, t_k, t_p))
            log(f"  {name}: ok, max|dv| {err:.2e}, kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
    # ties: copies of each query's best row at a lower index must win
    z = torch.randn((8, d), generator=gen, device=dev)
    best = nq.cosine_top1_plain(z, cb32)[1].long()
    tie = cb32.clone()
    low = torch.arange(8, device=dev) * 7
    tie[low] = cb32[best]
    _, ti = nq.cosine_top1_cuda(z, tie)
    if not torch.equal(ti.long().cpu(), torch.minimum(low, best).cpu()):
        raise AssertionError(f"B3 tie: kernel {ti.tolist()}, want {torch.minimum(low, best).tolist()}")
    log("  B3 duplicated-row ties -> lowest index: ok")
    del cb32, cb, tie

    # -- B1/B2: the serving slab
    slab32 = torch.zeros((n_obj, n_pad, d), device=dev)
    for o in range(n_obj):
        slab32[o, :n_rows] = rows(n_rows)
    for dtype in (torch.float32, torch.bfloat16):
        slab = slab32.to(dtype)
        tag = str(dtype)[6:]
        for obj in objs:
            z = torch.randn((8, d), generator=gen, device=dev)
            name = f"B1 grouped_top1 obj={obj} B=8 {tag}"
            got = mc.grouped_codebook_top1(z, slab, obj, n_rows)
            plain = mc.grouped_codebook_top1_plain(z, slab, obj, n_rows)
            err = compare_topk(name, got, plain, ranking(z, slab[obj], n_rows, 1, 1))
            errs["grouped_codebook_top1"] = max(errs["grouped_codebook_top1"], err)
            msg = f"  {name}: ok, max|dv| {err:.2e}"
            if obj == objs[1]:
                t_k, t_p = time_pair(lambda: mc.grouped_codebook_top1(z, slab, obj, n_rows),
                                     lambda: mc.grouped_codebook_top1_plain(z, slab, obj, n_rows), reps)
                times.append((name, t_k, t_p))
                msg += f", kernel {t_k:.4f} ms, plain {t_p:.4f} ms"
            log(msg)
            for k in (1, 8, 32):
                for stride in (1, 36):
                    name = f"B2 grouped_topk obj={obj} B=8 k={k} stride={stride} {tag}"
                    got = mc.grouped_codebook_topk(z, slab, obj, n_rows, k=k, stride=stride)
                    plain = mc.grouped_codebook_topk_plain(z, slab, obj, n_rows, k=k, stride=stride)
                    err = compare_topk(name, got, plain, ranking(z, slab[obj], n_rows, stride, k))
                    errs["grouped_codebook_topk"] = max(errs["grouped_codebook_topk"], err)
                    msg = f"  {name}: ok, max|dv| {err:.2e}"
                    if obj == objs[1]:
                        t_k, t_p = time_pair(
                            lambda: mc.grouped_codebook_topk(z, slab, obj, n_rows, k=k, stride=stride),
                            lambda: mc.grouped_codebook_topk_plain(z, slab, obj, n_rows, k=k, stride=stride),
                            reps)
                        times.append((name, t_k, t_p))
                        msg += f", kernel {t_k:.4f} ms, plain {t_p:.4f} ms"
                    log(msg)
    # masked rows: the query's own code planted in the pad region and off
    # the stride must never be returned; on the stride it must
    obj = objs[1]
    z = torch.randn((8, d), generator=gen, device=dev)
    masked = slab32.clone()
    masked[obj, n_rows + 5] = l2_normalize(z[0])
    masked[obj, 37] = l2_normalize(z[1])  # 37 % 36 != 0
    masked[obj, 72] = l2_normalize(z[2])  # on the stride
    # ties in the slab: row 300's exact copies at 36 (lower) and 900 (higher)
    masked[obj, 36] = masked[obj, 300]
    masked[obj, 900] = masked[obj, 300]
    z[3] = masked[obj, 300]
    v1, i1 = mc.grouped_codebook_top1(z, masked, obj, n_rows)
    v2, i2 = mc.grouped_codebook_topk(z, masked, obj, n_rows, k=8, stride=36)
    p2 = mc.grouped_codebook_topk_plain(z, masked, obj, n_rows, k=8, stride=36)
    if (i1 >= n_rows).any() or int(i1[1]) != 37 or int(i2[2, 0]) != 72:
        raise AssertionError(f"masked rows: top1 {i1.tolist()}, topk row0 {i2[:3, 0].tolist()}")
    if (i2 % 36 != 0).any() or (i2 >= n_rows).any():
        raise AssertionError("masked rows: top-k returned a masked index")
    _, i3 = mc.grouped_codebook_topk(z[3:4], masked, obj, n_rows, k=3)
    if int(i1[3]) != 36 or i3[0].tolist() != [36, 300, 900]:
        raise AssertionError(f"slab ties: top1 {int(i1[3])}, top3 {i3[0].tolist()}")
    compare_topk("B2 masked", (v2, i2), p2, ranking(z, masked[obj], n_rows, 36, 8))
    log("  masked rows (pad region, off-stride) never returned; slab ties -> lowest index first: ok")
    del slab32, slab, masked
    torch.cuda.empty_cache()
    return errs, times


# ------------------------------------------------------------------ phase 4
def device_profile(fn, n_frames=8, top=6):
    """Wall ms and summed device ms of fn() under torch.profiler, with the
    largest device-time names (ms per frame); None when the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    from torch.autograd import DeviceType

    # device-side rows only (kernels, copies, memsets): summing the aten
    # rows as well would count each kernel twice
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = [(k, v) for k, v in rows if v > 0]
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    return {
        "wall_ms": wall,
        "device_ms": sum(v for _, v in rows),
        "top_ms_per_frame": [(k[:60], v / n_frames) for k, v in rows[:top]],
    }


def _angles(Ra, Rb):
    """Geodesic angles (deg) between rotation stacks Ra (n,3,3) and Rb (m,3,3)."""
    import numpy as np

    tr = np.einsum("nij,mij->nm", Ra, Rb)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def serving_phase(root, device, template_text, n_frames=8, dets=8, image_hw=(540, 720),
                  box_range=(60, 200)):
    """Build the planted workspace under `root` and drive the serving path.
    Returns a summary dict; raises on any failed check."""
    import numpy as np
    import torch

    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch.models import AAE
    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.pose import AePoseEstimator, BoundingBox
    from augmentedautoencoder_torch.pose.estimator import extract_square_patch_centered
    from augmentedautoencoder_torch.serving import PoseServer
    from augmentedautoencoder_torch.training.checkpoint import CheckpointManager

    ws_path = os.path.join(root, "workspace")
    os.environ["AE_WORKSPACE_PATH"] = ws_path
    os.makedirs(os.path.join(ws_path, "cfg"), exist_ok=True)
    classes = {f"obj_{i:02d}": f"exp_{i}" for i in range(3)}
    for exp in classes.values():
        with open(os.path.join(ws_path, "cfg", f"{exp}.cfg"), "w") as fh:
            fh.write(template_text)
    cfg, _ = factory.load_experiment_config("exp_0")
    H, W = image_hw
    K = cfg.K
    rng = np.random.RandomState(0)

    # frames: random images, `dets` boxes per class per frame
    frames = []
    for _ in range(n_frames):
        img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        boxes = []
        for cls in classes:
            for _ in range(dets):
                w, h = rng.randint(*box_range, size=2)
                x, y = rng.randint(0, W - w), rng.randint(0, H - h)
                boxes.append(BoundingBox(xmin=x / W, ymin=y / H, xmax=(x + w) / W,
                                         ymax=(y + h) / H, classes={cls: 0.9}))
        frames.append({"bboxes": boxes, "color_img": img, "camK": K})

    # seeded full-width encoders; the frames' crops encoded in f32 are the
    # codes planted in each class's codebook
    views = factory.embedding_viewsphere(cfg)
    n_rows = len(views)
    models, crops_by_class = {}, {cls: [] for cls in classes}
    for i, cls in enumerate(classes):
        torch.manual_seed(i)
        models[cls] = AAE.from_config(cfg, precision="float32").to(device).eval()
    for fr in frames:
        for box in fr["bboxes"]:
            cls = box.best_class
            crops_by_class[cls].append(extract_square_patch_centered(
                fr["color_img"], box.to_xywh(W, H), cfg.pad_factor, resize=(cfg.w, cfg.h),
                interpolation="linear", black_borders=True))
    planted, codebooks = {}, {}
    for i, (cls, exp) in enumerate(classes.items()):
        with torch.no_grad():
            x = torch.from_numpy(np.stack(crops_by_class[cls])).to(device)
            codes = models[cls].encode(x.to(torch.float32) / 255.0).double().cpu().numpy()
        codes /= np.linalg.norm(codes, axis=1, keepdims=True)
        cos = codes @ codes.T - 2 * np.eye(len(codes))
        if cos.max() > 0.999:
            raise AssertionError(f"{cls}: two planted codes have cosine {cos.max():.5f}")
        # planted rows whose rotations are >= 40 deg apart, so aggregation
        # never blends two planted views
        chosen = []
        for r in rng.permutation(n_rows):
            if not chosen or _angles(views[[r]], views[chosen]).min() >= 40.0:
                chosen.append(int(r))
                if len(chosen) == len(codes):
                    break
        if len(chosen) < len(codes):
            raise AssertionError(f"only {len(chosen)} rotations 40 deg apart")
        idx = np.asarray(chosen)
        # random rows orthogonal to every planted code; rows within 25 deg of
        # a planted rotation hold the planted codes' mean direction negated,
        # so no neighbour of a planted view can enter a top-8 blend
        emb = rng.randn(n_rows, codes.shape[1])
        basis, _ = np.linalg.qr(codes.T)
        emb -= (emb @ basis) @ basis.T
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        away = -codes.mean(axis=0)
        away /= np.linalg.norm(away)
        if (codes @ away).max() >= 0:
            raise AssertionError(f"{cls}: planted codes have no common half-space")
        emb[_angles(views[idx], views).min(axis=0) < 25.0] = away
        emb[idx] = codes
        wh = rng.randint(80, 160, (n_rows, 2))
        xy = np.array([K[0, 2], K[1, 2]]) - wh / 2 + rng.randint(-4, 5, (n_rows, 2))
        bbs = np.concatenate([xy, wh], axis=1).astype(np.int32)
        ckpt_dir = factory.experiment_paths(exp)["checkpoint_dir"]
        CheckpointManager(ckpt_dir).save(0, models[cls].state_dict(), emb.astype(np.float32), bbs)
        planted[cls] = list(idx)
        codebooks[cls] = (emb.astype(np.float32), bbs)
        log(f"  {cls}: {n_rows} rows, {len(idx)} planted codes, max cosine between them {cos.max():.4f}")
    del models

    # expected pose of every detection: its planted row's pose
    from augmentedautoencoder_torch.codebook import Codebook

    cbs = {cls: Codebook(None, views, emb, bbs, cfg.num_cyclo) for cls, (emb, bbs) in codebooks.items()}
    expected, taken = [], {cls: 0 for cls in classes}
    for fr in frames:
        want = []
        for box in fr["bboxes"]:
            cls = box.best_class
            p = planted[cls][taken[cls]]
            taken[cls] += 1
            Rs, ts = cbs[cls].pose6d_from_indices(np.array([p]), np.array([box.to_xywh(W, H)]), K, cfg)
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = Rs[0], ts[0] / 1000.0
            want.append(T)
        expected.append(want)

    def check(name, got, want, atol=1e-4):
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} poses for {len(want)} detections")
        err = max(float(np.abs(p.trafo - T).max()) for p, T in zip(got, want))
        if not err <= atol:
            raise AssertionError(f"{name}: trafo differs by {err} > {atol}")
        return err

    head = ("[auto_pose]\ncamPose = False\nupright = False\ntopk = 1\ncolor_format = bgr\n"
            "color_data_type = np.float32\ndepth_data_type = np.float32\n"
            f"class_2_encoder = {classes!r}\n")
    recipes = {"f32_top1": ("float32", ""), "bf16_agg8": ("bfloat16", "topk_aggregate = 8\n")}
    cfg_paths = {}
    for name, (_, extra) in recipes.items():
        cfg_paths[name] = os.path.join(root, f"{name}.cfg")
        with open(cfg_paths[name], "w") as fh:
            fh.write(head + extra)

    servers = {
        name: PoseServer(cfg_paths[name], max_dets_per_class=dets, precision=prec,
                         device=device, profile=(name == "f32_top1"))
        for name, (prec, _) in recipes.items()
    }
    estimator = AePoseEstimator(cfg_paths["f32_top1"], device=device)
    wrappers = (mc.grouped_codebook_top1, mc.grouped_codebook_topk, nq.cosine_top1_cuda)

    # ---- the main path: counts from 0, read right after
    for fn in wrappers:
        fn.launches = 0
    summary = {"ms_per_frame": {}, "stages_ms": None}
    outputs = {}
    for name, srv in servers.items():
        check(f"{name} warm-up", srv.process(**frames[0]), expected[0])
        srv.profile_times.clear()
        srv.profile_frames = 0
        t0 = time.perf_counter()
        outs = list(srv.process_stream(iter(frames), depth=2))
        dt = time.perf_counter() - t0
        for i, (got, want) in enumerate(zip(outs, expected)):
            check(f"{name} frame {i}", got, want)
        if len(outs) != len(frames):
            raise AssertionError(f"{name}: {len(outs)} results for {len(frames)} frames")
        outputs[name] = outs
        summary["ms_per_frame"][name] = 1e3 * dt / len(frames)
        if srv.profile:
            summary["stages_ms"] = srv.profile_summary()
        log(f"  {name}: {len(frames)} frames x {len(frames[0]['bboxes'])} detections, planted poses "
            f"retrieved, {summary['ms_per_frame'][name]:.3f} ms/frame (host clock, process_stream)")
    t0 = time.perf_counter()
    check("AePoseEstimator", estimator.process(**frames[0]), expected[0])
    summary["estimator_ms"] = 1e3 * (time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"  AePoseEstimator frame 0: planted poses retrieved, {summary['estimator_ms']:.3f} ms")
    log(f"  main-path launches: {launches}")
    if str(device).startswith("cuda") and min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched by the main path: {launches}")
    summary["launches"] = launches
    if summary["stages_ms"]:
        log(f"  f32_top1 host stage split (ms/frame): "
            + ", ".join(f"{k} {v:.3f}" for k, v in summary["stages_ms"].items()))

    # ---- device busy share over the same stream, under torch.profiler
    if str(device).startswith("cuda"):
        summary["profile"] = {}
        for name, srv in servers.items():
            prof = device_profile(lambda: list(srv.process_stream(iter(frames), depth=2)))
            summary["profile"][name] = prof
            if prof is None:
                log(f"  {name}: torch.profiler saw no device time (busy share not measured)")
                continue
            top = ", ".join(f"{k} {v:.3f}" for k, v in prof["top_ms_per_frame"])
            log(f"  {name}: device busy {prof['device_ms'] / len(frames):.3f} of "
                f"{prof['wall_ms'] / len(frames):.3f} ms/frame under the profiler "
                f"({100 * prof['device_ms'] / prof['wall_ms']:.1f}% busy); top: {top}")

    # ---- one frame per recipe: the same server on the CPU
    for name, (prec, _) in recipes.items():
        cpu = PoseServer(cfg_paths[name], max_dets_per_class=dets, precision=prec, device="cpu")
        err = check(f"{name} GPU vs CPU", outputs[name][0], [p.trafo for p in cpu.process(**frames[0])])
        log(f"  {name}: frame 0 on GPU equals the CPU server (max |dtrafo| {err:.2e})")
    return summary


# ------------------------------------------------------------------ main
def main() -> int:
    smi = device_phase()
    sys.path.insert(0, REPO)
    import torch

    log("phase 2: build")
    build_phase()
    log(f"phase 3: kernels vs plain versions (values within {VAL_TOL}; indices equal where "
        f"the plain ranking's margin exceeds {MARGIN}; times: median of 20, cold L2)")
    errs, times = kernel_phase()
    log("phase 4: serving at full width")
    with open(TEMPLATE) as fh:
        template = fh.read()
    with tempfile.TemporaryDirectory(prefix="aae_chip_smoke_") as root:
        summary = serving_phase(root, "cuda", template)

    def timed(prefix):
        row = next(t for t in times if t[0].startswith(prefix))
        return row[1], row[2], row[0]

    kernels = []
    for name, replaces, prefix in (
        ("grouped_codebook_top1", "augmentedautoencoder_tpu/ops/multi_codebook.py:71",
         "B1 grouped_top1 obj=17 B=8 float32"),
        ("grouped_codebook_topk", "augmentedautoencoder_tpu/ops/multi_codebook.py:213",
         "B2 grouped_topk obj=17 B=8 k=8 stride=1 bfloat16"),
        ("cosine_top1_cuda", "augmentedautoencoder_tpu/ops/nn_query.py:112",
         "B3 cosine_top1 N=92232 B=8 float32"),
    ):
        ms, plain_ms, shape = timed(prefix)
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
            "launches": summary["launches"][name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms,
        })
        log(f"{name}: ms / plain_ms at {shape}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
