#!/usr/bin/env python3
"""Chip smoke test of augmentedautoencoder_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA toolkit) and this checkout; no network,
no jax, no TensorFlow. Phases, each fatal on failure:

  1. device   -- require CUDA, print the card's name and power limit, turn
                 TF32 off for the f32 arms;
  2. build    -- compile csrc/*.cu with nvcc (sm_90a) and, at the same time,
                 the host rasterizer with g++; print the seconds and the
                 ptxas resource report;
  3. kernels  -- each CUDA kernel against its plain PyTorch version on seeded
                 tensors at the serving shapes (92,232-row codebook; a
                 (30, 94,208, 128) slab in f32 and bf16; B in {8, 64} and,
                 for the top-1, 65 (two query chunks); k in {1, 8, 32};
                 stride in {1, 36}; duplicated-row ties; masked rows; top-1
                 calls back to back and an all-zero latent; latent widths
                 100 (B1-B3, operands stored with zero columns up to the
                 kernels' width, against the plain versions on the unpadded
                 ones) and 256 at B = 64 (B3; B2 at k 32, where its plan
                 takes smaller tiles or fewer queries per block); the ICP
                 nearest neighbour at
                 (8, 3000), the main path's shape, (24, 3000), (3, 3000) and
                 7 other shapes, with duplicated destination points and the
                 JAX (1, 8) tie; CUDA's x / n against the f32 reciprocal).
                 CUDA-event times of each port function whole and of its
                 kernel launch alone, the plain version and one PyTorch
                 library call computing the same function; the device rows
                 of one B1, one B2, one B3 and one B4 call under
                 torch.profiler (at most 2 launches, no PyTorch kernels);
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
  5. depth    -- depth-refined serving at the same width: 3 classes with
                 procedural textured meshes (5,120 faces, radius 18-23 mm,
                 so that 24 of them lie apart in the 540x720 frame at
                 0.7-0.8 m, the codebook's 700 mm render distance) as
                 MODEL_PATH, 8 frames of 24 detections on a grid whose depth
                 (rendered by the port's native rasterizer) puts each
                 object at its
                 planted rotation, 20-30 mm deeper than the projective
                 estimate along its viewing ray and up to 4 mm off
                 laterally. PoseServer bf16 +
                 topk_aggregate 8 + frame-accurate ICP through
                 process_stream (profile on), one PoseServer frame with
                 topk_rescore 4 + ICP, one AePoseEstimator f32 top-1 frame
                 with ICP. Checks that frame-accurate ICP brings the median
                 translation error under 6 mm and lowers the error of at
                 least 90% of the detections (listing the others), that
                 a one-detection frame of each recipe equals the port on the
                 CPU, and that every kernel was launched by this path.
  6. embed    -- the codebook build through cli.ae_embed.main at the width
                 and view count of the template (92,232 views at 128x128x3,
                 latent 128, batch 256: 361 batches, a 72-view tail) of a
                 procedural 5,120-face mesh (radius 40 mm) with seeded
                 weights. Checks the (92,232, 128) f32 unit-row embedding
                 and its (92,232, 4) int32 boxes, the checkpoint served by
                 build_codebook_from_name, the first batch and the tail
                 encoded again on the CPU from new renders (max |dz| <= 1e-4,
                 top-1 their own rows), 64 seeded views rendered again and
                 queried through Codebook.nearest_rotation (B3) returning
                 their own rows, and that B3 was launched by this path.
                 Prints views/s, the render / wait / H2D / encode / readback
                 split and the device busy share over 1,024 views.
  7. train    -- first the decoder's fused 2x convolution
                 (ops.fused_upconv.upsample2x_conv: four parity-phase 3x3
                 kernels in one cuDNN call, no upsampled map) against its
                 plain form (nearest 2x, then the 5x5 conv) in f32 without
                 TF32 at the template decoder's four 2x shapes at batch 64
                 (8->16 512->512, 16->32 512->256, 32->64 256->128, 64->128
                 128->3): the forward and the gradients of x, w and b within
                 UPCONV_RTOL of the plain form computed in f64, the bf16
                 fused and plain forms each within UPCONV_BF16_RTOL of the
                 same f64, each form's device ms in f32 and bf16, and one
                 full-width f32 step (ms, TFLOP, peak memory) under each
                 decoder. Then
                 training through cli.ae_train.main at the template's width
                 (128x128x3, filters [128, 256, 512, 512], latent 128, batch
                 64, L2 bootstrap 4, Adam 2e-4, the 8-op augmentation) on a
                 procedural 5,120-face mesh: 4,096 training pairs rendered
                 on the host threads (-gen; 512 pairs timed on 8 threads
                 and on 1, in pairs/s), 1,000 seeded
                 backgrounds (PNG files and the .npy cache), 200 steps with
                 checkpoints at 100 and 200. Checks the logged losses finite
                 and falling, chkpt-100 restored bit for bit and one step
                 from it, one batch-8 step on the card against the CPU port
                 from the same state and batch, compose_batch card vs CPU
                 from the same draws (the template's chain, and every
                 occlusion / clutter option with all 12 augmentation ops
                 and the combinators), chkpt-200 served by
                 restore_experiment. Prints ms/step (median of steps
                 50-200), its split into sample_batch / forward+backward /
                 optimizer, and the device busy share over 10 steps.
                 7b: the same experiment with PRECISION bfloat16 (the same
                 renders and backgrounds), 200 steps through
                 cli.ae_train.main: the losses finite and falling, every
                 parameter, statistic and optimizer slot f32 in the model and
                 both checkpoints, one batch-8 bf16 step on the card and on
                 the CPU each against the same step in f64
                 (BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_L2); ms/step beside
                 the f32 step's, TFLOP/s, peak memory, split, busy share.
  8. eval     -- the evaluation through cli.ae_eval.main at the template's
                 width (92,232-row codebook) on a BOP scene of 24 images at
                 720x540 (noise backgrounds, 3 instances each of a
                 procedural 5,120-face mesh at 0.7-0.8 m; rgb, 16-bit
                 depth, mask_visib, scene_gt_info written by the port's
                 renderer and PNG writer), each GT crop's code planted in
                 its GT view's row with a box 20-30 mm short in depth. Two
                 runs: (a) RGB with ERROR_TYPES vsd, re, te, add, adi (B4),
                 proj (B3); (b) ICP with ICP_FRAME_ACCURATE (B3, B4).
                 Checks the planted rows and re <= 1e-3 deg in (a), that
                 ICP lowers te for >= 90% of the estimates in (b) (the
                 others listed), the first images again on the CPU (the
                 same rows, poses within phase 5's bounds, errors equal in
                 (a) and close in (b)), and that B3 and B4 were launched by
                 this path. Prints seconds, estimates/s, the split (scene
                 load, crop, pose, icp, errors, matching, writing, figures)
                 and recall per error type; COMPUTE_PLOTS is on where
                 matplotlib imports.
  9. dsprites -- MODEL dsprites through cli.ae_train.main (100 steps at
                 64x64x1, the template's width and augmentation) and
                 cli.ae_embed.main (the 40-row orientation codebook) on a
                 synthetic dsprites-format .npz with the real latent grid
                 (737,280 seeded 64x64 sprites), then the codebook queried
                 against itself (B3). Checks the losses finite and falling,
                 the checkpoints, the unit-row codebook restored, its images
                 encoded on the card against the CPU port (max |dz| <=
                 1e-4), the query against its plain version, and that B3
                 was launched by this path.
  10. jpeg    -- the port's PIL decode of tests/fixtures/torch_port/
                 background_q95_420.jpg (baseline, 4:2:0, written by
                 cv2.imwrite) equal byte for byte to the stored cv2.imread
                 decode.
  11. import  -- cli.ae_import_tf.main on the committed TF1 checkpoint
                 tests/fixtures/torch_port/tf_ckpt (32x32x3, filters [8, 16],
                 latent 8, a 50-row codebook) with `tensorflow` blocked; the
                 test inputs' codes against TensorFlow's (1e-5), the 50 rows
                 retrieving their own images through B3, and frames of those
                 images served by AePoseEstimator (B3) and PoseServer f32
                 top-1 (B1), each equal to the CPU port; the import's
                 seconds.
  12. demo    -- the demos and the detector-data generators, with no
                 OpenCV, on phase 6's embedded experiment (92,232 rows,
                 latent 128; embedded again if its workspace is gone):
                 cli.aae_image on 16 crops of re-rendered codebook views
                 ((128, 256) estimates, own rows or duplicates within
                 MARGIN, panes the renders of their R, the first 4 crops'
                 rows on the CPU); cli.aae_webcam through the camera and
                 window seams (720x540 renders, 'q' after 8 frames: two
                 panes a frame, the camera released, rows = the CPU
                 port's); cli.detector_webcam_pose with
                 ForegroundContourDetector and a .pbtxt label map on 8
                 frames of 1-3 rendered objects on black (boxes = the
                 detector's, poses within DEMO_POSE_TOL of the CPU port,
                 overlays = the CPU's outside the text boxes; host ms a
                 frame split into detect / estimate / draw; the detector
                 alone on those frames, split into its steps);
                 PoseVisualizer and plot_scene_with_3d_boxes on phase 8's
                 scene with the card's and the CPU's estimates (equal);
                 cli.generate_syn_det_train and cli.generate_sixd_train, 4
                 scenes each at 720x540 (PNG and VOC XML, boxes inside the
                 frame, seconds a scene); B3's launches on this path.
  13. multi-GPU -- the `parallel` layer at the template's full width
                 (batch 64, filters [128, 256, 512, 512], latent 128), the
                 ranks spawned by parallel.dryrun.run_ranks (a file://
                 rendezvous; a rank that fails fails the phase): (1) DDP at
                 W = 1 over NCCL against the one-process step from the same
                 seeded model and generator, bit for bit (cuDNN's
                 deterministic algorithms); (2) dryrun_multigpu(2, "cuda"):
                 2 ranks (sharing card 0 over gloo on one card, NCCL on
                 two), 2 steps against the one-process step from the
                 Trainer's state (phase 7's bounds, parallel.dryrun's
                 LOSS_RTOL 1e-4, each gradient GRAD_RTOL 2e-2 of its
                 tensor's largest, the update given the same gradients
                 UPDATE_TOL 2e-6), the ranks' parameters equal; (3) its row-sharded B3 and B2 (k 8) queries on a
                 92,232-row f32 and bf16 codebook (8 queries, a row copied
                 into the other shard) against the replicated kernel
                 (indices where the margin exceeds MARGIN, values within
                 VAL_TOL, the tie to the lower row), host ms a call; (4) a
                 2-rank embed of phase 6's experiment's first 1,024 views
                 against the one-process rows (EMBED_RANK_TOL, boxes equal);
                 (5) with several cards, the same at W = the card count
                 over NCCL, host ms a step at global batch 64 and at 64 a
                 rank beside one process, and the 92,232-view embed over
                 every card beside one process in the same call (views/s).
                 B2 and B3's launches on this path (the sharded calls).

Each phase's seconds are printed after the last. The last lines are the kernels' JSON line, the nvidia-smi line, and
{"ok": true, "device": {...}}. Exits non-zero, without that line, on any
failure, without a GPU, or without the rest of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TEMPLATE = os.path.join(REPO, "augmentedautoencoder_torch", "cfg_templates", "train_template.cfg")
CODEBOOK_SOURCE = "augmentedautoencoder_torch/csrc/codebook_query.cu"
NN_SOURCE = "augmentedautoencoder_torch/csrc/icp_nn.cu"
MARGIN = 1e-5  # indices must agree where the plain ranking is not this close
VAL_TOL = 1e-5  # |kernel - plain| for every returned score
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bandwidth, f32 outside the
# tensor cores (f32 operands) and dense bf16 on the tensor cores (bf16
# operands, f32 accumulation)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
# B4's instruction floor: 6 f32 operations (no FMA), a compare and a select
# per pair, at 132 SMs x 128 f32 lanes x ~2.0 GHz
NN_INSTR_PER_PAIR = 8
F32_INSTR_PER_S = 33.8e12
SPIN_CYCLES = 1_000_000  # ~0.5 ms at ~2 GHz: longer than the host takes to issue one call
POSE_T_TOL_MM = 0.1  # GPU vs CPU port, depth-refined poses
POSE_R_TOL = 1e-3
# ICP's rotation-only stage (the reference's: R and x, y fitted, z held)
# can settle on a spurious rotation of a few degrees on a view that
# constrains rotation poorly; about the camera origin that moves the object
# by ~x sin(angle) in depth. Such detections are listed; more than this
# share of them fails the phase.
MAX_WORSE_SHARE = 0.1
# the codebook's codes, GPU against CPU, after normalization: cuDNN and the
# CPU sum the 5x5x512 convolutions in other orders
EMBED_CPU_TOL = 1e-4
# phase 13: the codebook built over ranks against the one-process build on
# the same card (the same batches through the same encoder)
EMBED_RANK_TOL = 1e-6
# phase 7, one train step on the card against the CPU port from the same
# state and batch (TF32 off on both): the loss within TRAIN_LOSS_RTOL; each
# parameter's gradient within TRAIN_GRAD_RTOL of that tensor's largest
# |gradient|; and the update, the CPU optimizer given the card's gradients
# against the card's parameters after its step, within 1% of one Adam step
# at the template's learning rate (2e-4). In f32 the two devices' gradients
# differ by the convolutions' summation orders, and by more where a pixel
# crosses the bootstrap's k-th value or a pre-activation crosses 0 on one
# device only: up to 2.5e-3 of a tensor's largest gradient (my chip runs;
# in f64 the two devices agree within 1e-14, scripts/train_grad_precision.py).
# Adam scales such a difference by each element's own gradient history, so
# the update is held to the card's gradients, not the CPU's.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 2e-2
TRAIN_PARAM_TOL = 2e-6
# compose_batch card vs CPU, augmented batch on [0, 1] (the affine's
# matmuls); the trained encoder served against the trainer's, same device
TRAIN_AUG_TOL = 1e-5
TRAIN_SERVE_TOL = 1e-5
# the decoder's fused 2x convolution against its plain form (upsample, then
# the 5x5 conv), f32 without TF32, forward and the gradients of x, w and b:
# each within UPCONV_RTOL of its tensor's largest |value| of the plain form
# computed in f64. Both are cuDNN f32 sums of the same products in other
# orders (36 against 100 taps a pixel); the f64 reference, because cuDNN's
# f32 weight gradient of the plain form at 3 output channels is itself
# 2.7e-2 off it (NVIDIA H100 80GB HBM3, 700 W; the fused form's 4e-7).
UPCONV_RTOL = 1e-4
# the same in bf16 (the forms of a PRECISION bfloat16 decoder, operands
# rounded to bf16), fused and plain each against the plain form in f64 on
# the same operands: two bf16 ulps of the largest |value|, as
# tests/test_torch_bf16_train.py holds one op (each output is rounded to bf16
# once; the fused and the plain forms round some elements apart).
UPCONV_BF16_RTOL = 2.0 ** -7
# phase 7's bf16 arm, one batch-8 step of the PRECISION bfloat16 model on
# the card and on the CPU, each against the same step in f64 (the port's
# modules in f64 throughout, models/reference.py) from the same parameters
# and batch: the loss within BF16_STEP_LOSS_RTOL, each parameter's gradient
# within BF16_STEP_GRAD_L2 in |d|_2 / |f64|_2. Fixed from the CPU measurement
# of tests/test_torch_bf16_train.py (32x32x3, filters [8, 16], latent 8,
# batch 4): the bf16 loss 1.3e-5 to 3.7e-4 from f64, the gradients' |d|_2 /
# |f64|_2 at most 7.7e-2 (the decoder's dense, where pre-activations cross 0
# in bf16 only), the others 3.9e-2 at most; the bounds are about 2.7x and
# 2x those.
BF16_STEP_LOSS_RTOL = 1e-3
BF16_STEP_GRAD_L2 = 0.15
# the template decoder's 2x steps: (input H = W, Cin, Cout), the last the
# reconstruction head
UPCONV_SHAPES = ((8, 512, 512), (16, 512, 256), (32, 256, 128), (64, 128, 3))
# the 12 augmentation ops and the combinators, for the card-vs-CPU check of
# the options the template leaves off
ALL_OPS_CODE = """Sequential([
    Sometimes(0.5, Affine(scale=(1.0, 1.2))), CoarseDropout(p=0.2, size_percent=0.05, per_channel=0.5),
    Dropout(p=0.1, per_channel=0.5), GaussianBlur((0.0, 1.5)), Add((-25, 25), per_channel=0.3),
    AdditiveGaussianNoise(scale=(0.0, 12.0), per_channel=0.5), Multiply((0.6, 1.4), per_channel=0.5),
    Invert(0.2, per_channel=True), ContrastNormalization((0.5, 2.2), per_channel=0.3),
    OneOf([Fliplr(0.5), Flipud(0.5), Grayscale((0.0, 1.0)), Noop()]),
    Sequential([Add((-10, 10)), Multiply((0.9, 1.1))], random_order=True)])"""


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
    from concurrent.futures import ThreadPoolExecutor

    from augmentedautoencoder_torch.ops import _cuda
    from augmentedautoencoder_torch.renderer.native import binding

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(binding.build)  # g++ while nvcc runs
        path = _cuda.build()
        _cuda.lib()
        host_path = host.result()
    binding.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(path, REPO)}, "
        f"{os.path.relpath(host_path, REPO)}")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")


# ------------------------------------------------------------------ phase 3
def time_fns(fns, reps=20, warmup=3):
    """Median device ms per call of each fn() by CUDA events: `reps` calls
    each after warm-up, in turns (in order, then reversed), with the 50 MB
    L2 flushed before every call (serving reads each class's plane once
    per frame, after the encoder has swept the cache) and a spin kernel
    queued after the flush, so that the host has issued the whole call
    before the start event is reached: the time between the events is the
    device's, without the host's launch overhead. The last result of each
    is read back to the host. Returns {tag: ms}."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")  # 256 MB
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    order = list(fns)
    runs = {tag: [] for tag in order}
    last = {}
    for tag in (order + order[::-1]) * (reps // 2):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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

    return {tag: median(runs[tag]) for tag in order}


def call_ms(fns, calls=25, rounds=6):
    """Host-clock ms per call of each fn() in fns, issued back to back (warm
    L2) in runs of `calls` with one synchronisation at the end of each: the
    cost of the call in a loop that issues it again and again, the host's
    launch overhead included. The functions take turns (ABC CBA ...), so
    drift of the host's speed falls on all alike; median over the runs."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    order = list(fns)
    runs = {tag: [] for tag in order}
    for tag in (order + order[::-1]) * (rounds // 2):
        t0 = time.perf_counter()
        for _ in range(calls):
            fns[tag]()
        torch.cuda.synchronize()
        runs[tag].append(1e3 * (time.perf_counter() - t0) / calls)
    return {tag: sorted(ms)[len(ms) // 2] for tag, ms in runs.items()}


def timed(name, cost, reps, **fns):
    """Times whole (the port's function from the user's inputs), launch
    (the kernel's binding on operands already in its input form), plain and
    library on the device, and the whole function and the library call per
    call on the host clock; logs them and returns the record of the
    kernels' JSON line."""
    t = time_fns(fns, reps)
    calls = call_ms({tag: fns[tag] for tag in ("whole", "library") if tag in fns})
    log(f"  {name}: device " + ", ".join(f"{tag} {ms:.4f}" for tag, ms in t.items())
        + f" ms; per call (host clock) " + ", ".join(f"{tag} {ms:.4f}" for tag, ms in calls.items())
        + f" ms; bound {bound_ms(*cost)[0]:.4f} ms")
    return {"shape": name, "ms": t["whole"], "launch_ms": t["launch"], "plain_ms": t["plain"],
            "library_ms": t.get("library"), "call_ms": calls["whole"],
            "library_call_ms": calls.get("library"), "n_bytes": cost[0], "flops": cost[1], "peak": cost[2]}


def device_rows(fn, calls=4):
    """(name, launches per call, device ms per call) of the device-side rows
    torch.profiler records over `calls` calls of fn(), after one warm-up
    call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count / calls, e.self_device_time_total / 1e3 / calls) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count > 0]


def show_rows(name, rows, allowed):
    """Logs the device rows of one call; fails unless every row is one of
    the kernels in `allowed` and a call makes at most 2 launches."""
    log(f"  {name}, device rows per call under torch.profiler: "
        + ("; ".join(f"{k[:48]} x{c:g} {ms:.4f} ms" for k, c, ms in rows) or "none"))
    if not rows:
        raise AssertionError(f"{name}: torch.profiler saw no device rows, so the launches per call "
                             "were not measured")
    launches = sum(c for _, c, _ in rows)
    if launches > 2 or any(not any(a in k for a in allowed) for k, _, _ in rows):
        raise AssertionError(f"{name}: {launches:g} device launches per call {rows}, want <= 2 of {allowed}")


def bound_ms(n_bytes, flops, peak):
    """The least time the card could take: (ms, "bytes" or "operations"),
    the operations at `peak` FLOP/s (the rate for their operands' type)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def top1_checks(name, fn, plain_fn, z, rank_fn):
    """A top-1 wrapper fn against its plain version on z, then on -z and z
    issued back to back with no synchronisation between them (each launch
    must leave its arrival counters reset for the next), and on an all-zero
    latent (every score 0: row 0 wins). Returns max |dv|."""
    import torch

    err = compare_topk(name, fn(z), plain_fn(z), rank_fn(z))
    neg, pos = fn(-z), fn(z)
    err = max(err, compare_topk(f"{name} (-z, back to back)", neg, plain_fn(-z), rank_fn(-z)),
              compare_topk(f"{name} (z, back to back)", pos, plain_fn(z), rank_fn(z)))
    _, i0 = fn(torch.zeros_like(z))
    if bool((i0 != 0).any()):
        raise AssertionError(f"{name}: an all-zero latent returned rows {i0.tolist()}, want 0")
    log(f"  {name}: ok, max|dv| {err:.2e}; back to back (-z, z): ok; all-zero latent -> row 0: ok")
    return err


def top1_target(name, rec, dtype, b):
    """Logs a top-1 timing against its bound and, at B = 8, against the
    design goal: the whole function within 2.5x of its byte bound (device,
    cold L2)."""
    import torch

    bound, by = bound_ms(rec["n_bytes"], rec["flops"], rec["peak"])
    goal = ""
    if b == 8:
        verdict = "met" if rec["ms"] <= 2.5 * bound else "NOT met"
        goal = f"; goal <= 2.5x ({'0.035' if dtype == torch.float32 else '0.018'} ms): {verdict}"
    log(f"  {name}: whole {rec['ms']:.4f} ms = {rec['ms'] / bound:.2f}x, launch alone "
        f"{rec['launch_ms']:.4f} ms = {rec['launch_ms'] / bound:.2f}x the {bound:.4f} ms bound ({by}){goal}")


def width_phase(n_rows=92_232, n_obj=2, seed=3):
    """B1-B3 at latent widths the kernels do not copy as they are: the
    operands stored with zero columns up to `_cuda.stream_width` (as the
    server and the Codebook store them), unpadded queries, against the plain
    versions on the UNPADDED operands (D = 100 in f32 and bf16; B3 and B2
    (k 32) also at D = 256, B = 64, where 64 queries of a block with their
    scores and lists do not fit next to two 32-row stages and the plans take
    smaller tiles or fewer queries per block). Returns max |dv| per kernel."""
    import torch

    from augmentedautoencoder_torch.ops import _cuda
    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.ops.nn_query import l2_normalize, pad_columns, topk_lowest_index

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pad = -(-n_rows // 2048) * 2048
    errs = {"cosine_top1_cuda": 0.0, "grouped_codebook_top1": 0.0, "grouped_codebook_topk": 0.0}

    def ranking(z, plane, stride, k):
        s = l2_normalize(z.float()).to(plane.dtype).float() @ plane.float().T
        col = torch.arange(s.shape[1], device=dev)
        s = torch.where(((col < n_rows) & (col % stride == 0))[None], s, torch.full_like(s, -2.0))
        return topk_lowest_index(s, k + 1)[0]

    for d, b, dtypes in ((100, 8, (torch.float32, torch.bfloat16)), (256, 64, (torch.float32, torch.bfloat16))):
        cb32 = l2_normalize(torch.randn((n_rows, d), generator=gen, device=dev))
        for dtype in dtypes:
            tag = f"D={d} B={b} {str(dtype)[6:]}"
            cb = cb32.to(dtype)
            cbp = pad_columns(cb, _cuda.stream_width(d, dtype)).contiguous()
            z = torch.randn((b, d), generator=gen, device=dev)
            got = nq.cosine_top1_cuda(z, cbp)
            err = compare_topk(f"B3 {tag}", got, nq.cosine_top1_plain(z, cb), ranking(z, cb, 1, 1))
            errs["cosine_top1_cuda"] = max(errs["cosine_top1_cuda"], err)
            plan = _cuda.plan_top1_stream(b, n_rows, cbp.shape[1], cbp.element_size(),
                                          _cuda.sm_count(0), _cuda.smem_limits(0))
            log(f"  B3 cosine_top1 {tag} (stored width {cbp.shape[1]}): ok, max|dv| {err:.2e} "
                f"({plan.q_per_block} queries per block, {plan.rows_per_tile}-row tiles, {plan.stages} stages)")
            slab = torch.zeros((n_obj, n_pad, d), dtype=dtype, device=dev)
            slab[:, :n_rows] = cb
            slab[0, :n_rows] = cb.flip(0)
            slabp = mc.pad_slab(slab)
            if d == 256:  # B2's width repair: the shape its plan used to refuse
                plan = _cuda.plan_topk_stream(b, n_pad, slabp.shape[-1], slabp.element_size(), 32,
                                              _cuda.sm_count(0), _cuda.smem_limits(0))
                for obj in range(n_obj):
                    for stride in (1, 36):
                        got = mc.grouped_codebook_topk(z, slabp, obj, n_rows, k=32, stride=stride)
                        plain = mc.grouped_codebook_topk_plain(z, slab, obj, n_rows, k=32, stride=stride)
                        err = compare_topk(f"B2 {tag} k=32 stride={stride}", got, plain,
                                           ranking(z, slab[obj], stride, 32))
                        errs["grouped_codebook_topk"] = max(errs["grouped_codebook_topk"], err)
                log(f"  B2 grouped_topk {tag} k=32 (stride 1 and 36, planes 0 and 1): ok, max|dv| "
                    f"{errs['grouped_codebook_topk']:.2e} ({plan.q_per_block} queries per block, "
                    f"{plan.rows_per_tile}-row tiles, {plan.stages} stages)")
                del slab, slabp
                continue
            for obj in range(n_obj):
                got = mc.grouped_codebook_top1(z, slabp, obj, n_rows)
                err = compare_topk(f"B1 {tag}", got, mc.grouped_codebook_top1_plain(z, slab, obj, n_rows),
                                   ranking(z, slab[obj], 1, 1))
                errs["grouped_codebook_top1"] = max(errs["grouped_codebook_top1"], err)
                for k, stride in ((8, 1), (8, 36), (1, 36)):
                    got = mc.grouped_codebook_topk(z, slabp, obj, n_rows, k=k, stride=stride)
                    plain = mc.grouped_codebook_topk_plain(z, slab, obj, n_rows, k=k, stride=stride)
                    err = compare_topk(f"B2 {tag} k={k} stride={stride}", got, plain,
                                       ranking(z, slab[obj], stride, k))
                    errs["grouped_codebook_topk"] = max(errs["grouped_codebook_topk"], err)
            log(f"  B1, B2 (k 8 and 1, stride 1 and 36) {tag} on a slab stored at width {slabp.shape[-1]}, "
                f"planes 0 and 1: ok, max|dv| {errs['grouped_codebook_top1']:.2e}, "
                f"{errs['grouped_codebook_topk']:.2e}")
            del slab, slabp
        del cb32, cb, cbp
    torch.cuda.empty_cache()
    return errs


def library_topk(z, plane, k):
    """The library yardstick of B1-B3: one matmul and torch.topk over the
    plane's rows (in the plane's dtype; a strided view for `upright`)."""
    import torch

    from augmentedautoencoder_torch.ops.nn_query import l2_normalize

    return torch.topk(l2_normalize(z.float()).to(plane.dtype) @ plane.T, k, dim=1)


def query_cost(z, cb, n_rows, k):
    """(bytes, flops, peak FLOP/s) of a codebook query: the plane's n_rows
    rows and the queries read once, (B, k) values and indices written;
    2 * B * n_rows * D operations, at the f32 rate for an f32 codebook and
    the bf16 tensor-core rate for a bf16 one."""
    b, d = z.shape
    peak = BF16_FLOPS if cb.element_size() == 2 else F32_FLOPS
    return n_rows * d * cb.element_size() + b * d * 4 + b * k * 8, 2 * b * n_rows * d, peak


def kernel_phase(n_rows=92_232, n_obj=30, d=128, objs=(0, 17, 29), bs=(8, 64), reps=20):
    """B1-B3 against their plain versions. Returns (max |dv| per kernel,
    {kernel name: timing record at the main path's shape})."""
    import torch

    from augmentedautoencoder_torch.ops import _cuda
    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.ops.nn_query import l2_normalize, topk_lowest_index

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_pad = -(-n_rows // 2048) * 2048
    errs = {"cosine_top1_cuda": 0.0, "grouped_codebook_top1": 0.0, "grouped_codebook_topk": 0.0}
    records = {}

    def rows(n):
        return l2_normalize(torch.randn((n, d), generator=gen, device=dev))

    def ranking(z, plane, n_valid, stride, k):
        """The plain masked scores' top-(k+1) values, for the margin rule."""
        s = l2_normalize(z.float()).to(plane.dtype).float() @ plane.float().T
        col = torch.arange(s.shape[1], device=dev)
        valid = (col < n_valid) & ((col % stride) == 0)
        s = torch.where(valid[None], s, torch.full_like(s, -2.0))
        return topk_lowest_index(s, k + 1)[0]

    def prep(z, cb):  # the kernels' query operand
        return l2_normalize(z.float()).to(cb.dtype).contiguous()

    # -- B3: single-codebook top-1 (estimator path); B = 65 runs two query chunks
    cb32 = rows(n_rows)
    for dtype in (torch.float32, torch.bfloat16):
        cb = cb32.to(dtype)
        for b in (*bs, 65):
            z = torch.randn((b, d), generator=gen, device=dev)
            name = f"B3 cosine_top1 N={n_rows} B={b} {str(dtype)[6:]}"
            err = top1_checks(name, lambda x: nq.cosine_top1_cuda(x, cb), lambda x: nq.cosine_top1_plain(x, cb),
                              z, lambda x: ranking(x, cb, n_rows, 1, 1))
            errs["cosine_top1_cuda"] = max(errs["cosine_top1_cuda"], err)
            if b not in bs:
                continue
            q = prep(z, cb)
            rec = timed(name, query_cost(z, cb, n_rows, 1), reps,
                        whole=lambda: nq.cosine_top1_cuda(z, cb),
                        launch=lambda: _cuda.codebook_top1_stream(q, cb, 0, n_rows, n_rows),
                        plain=lambda: nq.cosine_top1_plain(z, cb),
                        library=lambda: library_topk(z, cb, 1))
            top1_target(name, rec, dtype, b)
            if dtype == torch.float32 and b == 8:
                records["cosine_top1_cuda"] = rec
                show_rows(name, device_rows(lambda: _cuda.codebook_top1_stream(q, cb, 0, n_rows, n_rows)),
                          ("top1_stream_kernel",))
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
        for b in bs:
            for obj in (objs if b == 8 else objs[1:2]):
                z = torch.randn((b, d), generator=gen, device=dev)
                q = prep(z, slab)
                name = f"B1 grouped_top1 obj={obj} B={b} {tag}"
                err = top1_checks(name, lambda x: mc.grouped_codebook_top1(x, slab, obj, n_rows),
                                  lambda x: mc.grouped_codebook_top1_plain(x, slab, obj, n_rows), z,
                                  lambda x: ranking(x, slab[obj], n_rows, 1, 1))
                errs["grouped_codebook_top1"] = max(errs["grouped_codebook_top1"], err)
                if obj == objs[1]:
                    rec = timed(name, query_cost(z, slab, n_rows, 1), reps,
                                whole=lambda: mc.grouped_codebook_top1(z, slab, obj, n_rows),
                                launch=lambda: _cuda.codebook_top1_stream(q, slab, obj, n_pad, n_rows),
                                plain=lambda: mc.grouped_codebook_top1_plain(z, slab, obj, n_rows),
                                library=lambda: library_topk(z, slab[obj, :n_rows], 1))
                    top1_target(name, rec, dtype, b)
                    if dtype == torch.float32 and b == 8:
                        records["grouped_codebook_top1"] = rec
                        show_rows(name, device_rows(
                            lambda: _cuda.codebook_top1_stream(q, slab, obj, n_pad, n_rows)),
                            ("top1_stream_kernel",))
                for k in (1, 8, 32):
                    for stride in (1, 36):
                        name = f"B2 grouped_topk obj={obj} B={b} k={k} stride={stride} {tag}"
                        got = mc.grouped_codebook_topk(z, slab, obj, n_rows, k=k, stride=stride)
                        plain = mc.grouped_codebook_topk_plain(z, slab, obj, n_rows, k=k, stride=stride)
                        err = compare_topk(name, got, plain, ranking(z, slab[obj], n_rows, stride, k))
                        errs["grouped_codebook_topk"] = max(errs["grouped_codebook_topk"], err)
                        log(f"  {name}: ok, max|dv| {err:.2e}")
                        # timed: the recipes' shapes (agg8; upright top-1 at B = 8)
                        if obj != objs[1] or (k, stride) not in ((8, 1), (1, 36)) or (b > 8 and k == 1):
                            continue
                        rec = timed(
                            name, query_cost(z, slab, n_rows, k), reps,
                            whole=lambda: mc.grouped_codebook_topk(z, slab, obj, n_rows, k=k, stride=stride),
                            launch=lambda: _cuda.codebook_topk_stream(q, slab, obj, n_pad, n_rows, stride, k),
                            plain=lambda: mc.grouped_codebook_topk_plain(z, slab, obj, n_rows, k=k, stride=stride),
                            library=lambda: library_topk(z, slab[obj, :n_rows:stride], k))
                        if (b, k, stride, dtype) == (8, 8, 1, torch.bfloat16):
                            records["grouped_codebook_topk"] = rec
                            show_rows(name, device_rows(
                                lambda: _cuda.codebook_topk_stream(q, slab, obj, n_pad, n_rows, stride, k)),
                                ("topk_stream_kernel", "topk_merge_wide_kernel"))
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
    for dtype in (torch.float32, torch.bfloat16):
        m = masked.to(dtype)
        v1, i1 = mc.grouped_codebook_top1(z, m, obj, n_rows)
        v2, i2 = mc.grouped_codebook_topk(z, m, obj, n_rows, k=8, stride=36)
        p2 = mc.grouped_codebook_topk_plain(z, m, obj, n_rows, k=8, stride=36)
        if (i1 >= n_rows).any() or int(i1[1]) != 37 or int(i2[2, 0]) != 72:
            raise AssertionError(f"masked rows: top1 {i1.tolist()}, topk row0 {i2[:3, 0].tolist()}")
        if (i2 % 36 != 0).any() or (i2 >= n_rows).any():
            raise AssertionError("masked rows: top-k returned a masked index")
        _, i3 = mc.grouped_codebook_topk(z[3:4], m, obj, n_rows, k=3)
        if int(i1[3]) != 36 or i3[0].tolist() != [36, 300, 900]:
            raise AssertionError(f"slab ties: top1 {int(i1[3])}, top3 {i3[0].tolist()}")
        errs["grouped_codebook_topk"] = max(errs["grouped_codebook_topk"], compare_topk(
            "B2 masked", (v2, i2), p2, ranking(z, m[obj], n_rows, 36, 8)))
    log("  masked rows (pad region, off-stride) never returned; slab ties -> lowest index first "
        "(f32 and bf16): ok")
    del slab32, slab, masked, m
    torch.cuda.empty_cache()
    return errs, records


def nn_phase(reps=20):
    """B4: batched_nn_cuda against batched_nn_torch on the card. Indices
    must be equal everywhere and distances identical (max |d dist| 0): the
    kernel repeats every rounding of the plain version. Returns (max |d
    dist|, timing record at the main path's shape (8, 3000))."""
    import torch

    from augmentedautoencoder_torch.ops import _cuda, icp_nn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    # the repaired tree_mean: CUDA's x / n is x * (f32 reciprocal of n)
    for N in range(1, 5001):
        x = torch.randn((8, 3), generator=gen, device=dev) * 3000.0 + 700.0 * N
        if not torch.equal(x / N, x * icp_nn.recip_f32(N)):
            raise AssertionError(f"x / {N} != x * recip_f32({N}) on CUDA")
    for n, N in ((8, 3000), (24, 3000), (1, 3000)):
        x = torch.randn((n, N, 3), generator=gen, device=dev) * 60.0 + 700.0
        t = icp_nn.tree_sum(x, 1)
        if not torch.equal(t / N, icp_nn.tree_mean(x, 1)):
            raise AssertionError(f"tree_mean differs from tree_sum / N on CUDA at ({n}, {N})")
    log("  tree_mean: x / n equals x * recip_f32(n) on CUDA for n = 1..5000 and the loop's "
        "(8|24|1, 3000, 3) sums: ok")

    def clouds(n, N, scale=60.0, z=700.0):
        src = torch.randn((n, N, 3), generator=gen, device=dev) * scale
        dst = torch.randn((n, N, 3), generator=gen, device=dev) * scale
        src[..., 2] += z
        dst[..., 2] += z
        return src, dst

    def library(src, dst):  # the yardstick: one distance matrix and its argmin
        return (torch.cdist(src, dst).argmin(-1),)

    def compare(name, src, dst):
        got = icp_nn.batched_nn_cuda(src, dst)
        want = icp_nn.batched_nn_torch(src, dst)
        torch.cuda.synchronize()
        if not torch.equal(got[1], want[1]):
            bad = int((got[1] != want[1]).sum())
            raise AssertionError(f"{name}: {bad} nearest-neighbour indices differ from the plain version")
        err = float((got[0] - want[0]).abs().max())
        if err != 0.0:
            raise AssertionError(f"{name}: distances differ from the plain version by {err}")
        return got

    sms = _cuda.sm_count(dev.index or 0)
    record = None
    for n, N in ((8, 3000), (24, 3000), (3, 3000), (2, 100), (1, 1025), (5, 2999), (2, 5000),
                 (1, 20001), (1, 1), (3, 7)):
        src, dst = clouds(n, N)
        name = f"B4 batched_nn n={n} N={N}"
        compare(name, src, dst)
        split_len, splits = _cuda.plan_nn(n, N, sms)
        log(f"  {name}: ok, indices equal, max|d dist| 0 ({splits} destination splits of {split_len})")
        if N != 3000:
            continue
        # 3 multiplies and 3 adds a pair; read src and dst, write dist and idx
        cost = (n * N * 6 * 4 + n * N * 8, 6 * n * N * N, F32_FLOPS)
        rec = timed(name, cost, reps,
                    whole=lambda: icp_nn.batched_nn_cuda(src, dst),
                    launch=lambda: _cuda.batched_nn(src, dst),
                    plain=lambda: icp_nn.batched_nn_torch(src, dst),
                    library=lambda: library(src, dst))
        # worked out from assumed rates, not measured: logged, not in the kernels line
        floor = 1e3 * n * N * N * NN_INSTR_PER_PAIR / F32_INSTR_PER_S
        log(f"  {name}: instruction floor {floor:.4f} ms ({NN_INSTR_PER_PAIR} f32 instructions a pair "
            f"at {F32_INSTR_PER_S / 1e12:.1f} T/s); launch at {rec['launch_ms'] / floor:.2f}x of it")
        if n == 8:
            record = rec
            show_rows(name, device_rows(lambda: icp_nn.batched_nn_cuda(src, dst)),
                      ("nn_prep_kernel", "nn_search_kernel"))
    # ties: every dst point twice (second copy 1500 later) -> the lower index
    src, dst = clouds(24, 3000)
    dst[:, 1500:] = dst[:, :1500]
    _, idx = compare("B4 duplicated dst", src, dst)
    if int(idx.max()) >= 1500:
        raise AssertionError("B4 duplicated dst: a higher duplicate index won a tie")
    src = torch.zeros((1, 8, 3), device=dev)
    dst = torch.full((1, 8, 3), 5.0, device=dev)
    dst[0, 2] = dst[0, 6] = torch.tensor([1.0, 0.0, 0.0], device=dev)
    dist, idx = compare("B4 tie (JAX test case)", src, dst)
    if not (bool((idx == 2).all()) and float((dist - 1.0).abs().max()) < 1e-6):
        raise AssertionError(f"B4 tie: idx {idx.tolist()}, dist {dist.tolist()}")
    log("  B4 duplicated destination points -> lowest index; (1, 8) tie -> index 2: ok")
    return 0.0, record


# ------------------------------------------------------------------ phase 4
def device_profile(fn, n_frames=8, top=6, trace_dir=None):
    """Wall ms and summed device ms of fn() under torch.profiler, with the
    largest device-time names (ms per frame); None when the profiler
    records no device time. With `trace_dir` the profile is the port's
    `training.profiler.trace`, which also writes its Chrome trace there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if trace_dir is None:
        region = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    else:
        from augmentedautoencoder_torch.training.profiler import trace

        region = trace(trace_dir)
    torch.cuda.synchronize()
    with region as prof:
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


def plant_workspace(root, device, cfg_texts, make_frames, rng, planted_bb=None):
    """A workspace under `root` whose codebooks hold the codes of the frames'
    crops at known rows. cfg_texts: experiment `exp_i` -> its cfg text (class
    `obj_{i:02d}`); make_frames(cfg, rng) -> frames. Seeded full-width
    encoders encode every detection's crop in f32, and each class's
    92,232-row codebook gets those codes at rows whose rotations are >= 40
    deg apart; planted_bb(cfg, box) -> the rendered box (x, y, w, h) stored
    with the row planted for that detection (None: random boxes, like every
    other row).
    Returns (cfg, frames, expected) with expected[f][j] the 4x4 pose (m)
    of frame f's detection j: its planted row's pose."""
    import numpy as np
    import torch

    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch.codebook import Codebook
    from augmentedautoencoder_torch.models import AAE
    from augmentedautoencoder_torch.pose.estimator import extract_square_patch_centered
    from augmentedautoencoder_torch.training.checkpoint import CheckpointManager

    ws_path = os.path.join(root, "workspace")
    os.environ["AE_WORKSPACE_PATH"] = ws_path
    os.makedirs(os.path.join(ws_path, "cfg"), exist_ok=True)
    classes = {f"obj_{i:02d}": exp for i, exp in enumerate(cfg_texts)}
    for exp, text in cfg_texts.items():
        with open(os.path.join(ws_path, "cfg", f"{exp}.cfg"), "w") as fh:
            fh.write(text)
    cfg, _ = factory.load_experiment_config(next(iter(cfg_texts)))
    K = cfg.K
    frames = make_frames(cfg, rng)
    H, W = frames[0]["color_img"].shape[:2]

    # seeded full-width encoders; the frames' crops encoded in f32 are the
    # codes planted in each class's codebook
    views = factory.embedding_viewsphere(cfg)
    n_rows = len(views)
    models, crops_by_class, boxes_by_class = {}, {cls: [] for cls in classes}, {cls: [] for cls in classes}
    for i, cls in enumerate(classes):
        torch.manual_seed(i)
        models[cls] = AAE.from_config(cfg, precision="float32").to(device).eval()
    for fr in frames:
        for box in fr["bboxes"]:
            cls = box.best_class
            boxes_by_class[cls].append(box)
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
        if planted_bb is not None:
            bbs[idx] = np.array([planted_bb(cfg, b) for b in boxes_by_class[cls]], np.int32)
        ckpt_dir = factory.experiment_paths(exp)["checkpoint_dir"]
        CheckpointManager(ckpt_dir).save(0, models[cls].state_dict(), emb.astype(np.float32), bbs)
        planted[cls] = list(idx)
        codebooks[cls] = (emb.astype(np.float32), bbs)
        log(f"  {cls}: {n_rows} rows, {len(idx)} planted codes, max cosine between them {cos.max():.4f}")
    del models

    # expected pose of every detection: its planted row's pose
    cbs = {cls: Codebook(None, views, emb, bbs, cfg.num_cyclo, device=device)
           for cls, (emb, bbs) in codebooks.items()}
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
    return cfg, frames, expected


def serving_phase(root, device, template_text, n_frames=8, dets=8, image_hw=(540, 720),
                  box_range=(60, 200)):
    """Build the planted workspace under `root` and drive the serving path.
    Returns a summary dict; raises on any failed check."""
    import numpy as np
    import torch

    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.pose import AePoseEstimator, BoundingBox
    from augmentedautoencoder_torch.serving import PoseServer

    classes = {f"obj_{i:02d}": f"exp_{i}" for i in range(3)}
    H, W = image_hw

    def make_frames(cfg, rng):
        """Random images, `dets` boxes per class per frame."""
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
            frames.append({"bboxes": boxes, "color_img": img, "camK": cfg.K})
        return frames

    cfg, frames, expected = plant_workspace(
        root, device, {exp: template_text for exp in classes.values()}, make_frames,
        np.random.RandomState(0))

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


# ------------------------------------------------------------------ phase 5
def depth_phase(root, device, template_text, n_frames=8, grid=(4, 6), image_hw=(540, 720),
                radii=(18.0, 20.0, 23.0), z_range=(700.0, 800.0)):
    """Depth-refined serving at full width on a planted workspace whose
    classes render procedural meshes. Returns a summary dict; raises on any
    failed check."""
    import numpy as np
    import torch

    from augmentedautoencoder_torch.ops import icp_nn
    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.pose import AePoseEstimator, BoundingBox
    from augmentedautoencoder_torch.pose import icp as icp_mod
    from augmentedautoencoder_torch.renderer import Renderer, load_mesh
    from augmentedautoencoder_torch.renderer.procedural import make_textured_asymmetric, save_ply
    from augmentedautoencoder_torch.serving import PoseServer

    os.makedirs(root, exist_ok=True)
    H, W = image_hw
    rows, cols = grid
    n_cls = len(radii)
    meshes, cfg_texts = [], {}
    for i, radius in enumerate(radii):
        path = os.path.join(root, f"obj_{i:02d}.ply")
        save_ply(make_textured_asymmetric(subdivisions=4, radius=radius), path)
        meshes.append(load_mesh(path))
        cfg_texts[f"exp_{i}"] = "\n".join(
            f"MODEL_PATH: {path}" if line.startswith("MODEL_PATH") else line
            for line in template_text.splitlines()) + "\n"
    classes = [f"obj_{i:02d}" for i in range(n_cls)]
    extents = [float(np.linalg.norm(m.vertices, axis=1).max()) for m in meshes]  # ~1.39 x radius
    layout = np.random.RandomState(5)
    z_target = {}  # id(box) -> the depth its planted row's box encodes

    def make_frames(cfg, rng):
        """`rows` x `cols` grid of detections, class k % 3 in cell k, each
        box the projected extent of its mesh at a depth in z_range, so the
        padded crop holds the whole object and no neighbour."""
        f = cfg.K[0, 0]
        frames = []
        for _ in range(n_frames):
            boxes = []
            for k in range(rows * cols):
                cls = k % n_cls
                z = layout.uniform(*z_range)
                side = int(round(2.0 * f * extents[cls] / z))
                cx = (k % cols + 0.5) * W / cols + layout.randint(-6, 7)
                cy = (k // cols + 0.5) * H / rows + layout.randint(-6, 7)
                x, y = int(cx - side / 2), int(cy - side / 2)
                boxes.append(BoundingBox(xmin=x / W, ymin=y / H, xmax=(x + side) / W,
                                         ymax=(y + side) / H, classes={classes[cls]: 0.9}))
                z_target[id(boxes[-1])] = z
            frames.append({"bboxes": boxes, "color_img": rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
                           "camK": cfg.K})
        return frames

    def planted_bb(cfg, box):
        # a rendered box centred on the principal point whose size puts the
        # projective depth of this detection at its z_target (test K = train K)
        _, _, w, h = box.to_xywh(W, H)
        scale = z_target[id(box)] / cfg.radius
        w, h = w * scale, h * scale
        return [cfg.K[0, 2] - w / 2, cfg.K[1, 2] - h / 2, w, h]

    cfg, frames, expected = plant_workspace(root, device, cfg_texts, make_frames,
                                            np.random.RandomState(1), planted_bb)

    # the depth frames: each object at its planted rotation, 20-30 mm deeper
    # than the projective estimate along its viewing ray (the estimate's
    # error mode: depth from the box's scale), then up to 4 mm off laterally
    renderers = [Renderer([], backend="native", meshes=[m]) for m in meshes]
    offs = np.random.RandomState(2)
    truth = []
    for fr, want in zip(frames, expected):
        depth = np.zeros((H, W), np.float32)
        ts = []
        for box, T in zip(fr["bboxes"], want):
            ang, mag = offs.uniform(0, 2 * np.pi), offs.uniform(0, 4.0)
            t = 1000.0 * T[:3, 3]
            t = t * (1.0 + offs.uniform(20, 30) / t[2]) + np.array([mag * np.cos(ang), mag * np.sin(ang), 0.0])
            _, d = renderers[classes.index(box.best_class)].render(0, W, H, fr["camK"], T[:3, :3], t, 10, 10000)
            closer = (d > 0) & ((depth == 0) | (d < depth))
            depth[closer] = d[closer]
            ts.append(t)
        fr["depth_img"] = depth
        truth.append(np.array(ts))
    before = [1000.0 * np.array([T[:3, 3] for T in want]) for want in expected]

    head = ("[auto_pose]\ncamPose = False\nupright = False\ntopk = 1\ncolor_format = bgr\n"
            "color_data_type = np.float32\ndepth_data_type = np.float32\n"
            f"class_2_encoder = {dict(zip(classes, cfg_texts))!r}\nuse_icp = True\n")
    recipes = {
        "bf16_agg8_frame_icp": ("bfloat16", "topk_aggregate = 8\nicp_frame_accurate = True\n"),
        "f32_rescore4_icp": ("float32", "topk_rescore = 4\n"),
        "estimator_f32_top1_icp": ("float32", ""),
    }
    cfg_paths = {}
    for name, (_, extra) in recipes.items():
        cfg_paths[name] = os.path.join(root, f"{name}.cfg")
        with open(cfg_paths[name], "w") as fh:
            fh.write(head + extra)
    dets = len(frames[0]["bboxes"]) // n_cls
    srv = PoseServer(cfg_paths["bf16_agg8_frame_icp"], max_dets_per_class=dets, precision="bfloat16",
                     device=device, profile=True)
    rescore = PoseServer(cfg_paths["f32_rescore4_icp"], max_dets_per_class=dets, device=device)
    estimator = AePoseEstimator(cfg_paths["estimator_f32_top1_icp"], device=device)

    def t_errors(got, f):
        return np.linalg.norm(1000.0 * np.array([p.trafo[:3, 3] for p in got]) - truth[f], axis=1)

    # warm-up (builds each ICP handle), then the main path with counts from 0
    np.random.seed(0)
    for runner in (srv, rescore, estimator):
        runner.process(**frames[0])
    srv.profile_times.clear()
    srv.profile_frames = 0
    wrappers = (mc.grouped_codebook_top1, mc.grouped_codebook_topk, nq.cosine_top1_cuda,
                icp_nn.batched_nn_cuda)
    loop = {"seconds": 0.0, "iters": {"depth_only": [], "no_depth": []}}
    icp_batch = icp_mod.icp_batch

    def timed_icp_batch(As, Bs, *args, **kw):
        t0 = time.perf_counter()
        out = icp_batch(As, Bs, *args, **kw)
        loop["seconds"] += time.perf_counter() - t0
        loop["iters"]["depth_only" if kw.get("depth_only") else "no_depth"].append(max(o[2] for o in out))
        return out

    icp_mod.icp_batch = timed_icp_batch
    try:
        for fn in wrappers:
            fn.launches = 0
        np.random.seed(1)
        t0 = time.perf_counter()
        outs = list(srv.process_stream(iter(frames), depth=2))
        stream_s = time.perf_counter() - t0
        stream_launches = {fn.__name__: fn.launches for fn in wrappers}
        stream_loop, stream_iters = loop["seconds"], {k: list(v) for k, v in loop["iters"].items()}
        np.random.seed(2)
        t0 = time.perf_counter()
        out_rescore = rescore.process(**frames[0])
        rescore_ms = 1e3 * (time.perf_counter() - t0)
        np.random.seed(3)
        t0 = time.perf_counter()
        out_est = estimator.process(**frames[0])
        estimator_ms = 1e3 * (time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches for fn in wrappers}
    finally:
        icp_mod.icp_batch = icp_batch
    log(f"  main-path launches: {launches}")
    # B1 serves k = 1 without upright; every recipe here ranks top-k (B2)
    # or runs the estimator's single-codebook top-1 (B3)
    on_path = ("grouped_codebook_topk", "cosine_top1_cuda", "batched_nn_cuda")
    if str(device).startswith("cuda") and min(launches[k] for k in on_path) < 1:
        raise AssertionError(f"a kernel of the depth path was not launched by it: {launches}")

    # ---- ICP against the depth frame's true translations
    def judge(name, got, f):
        if len(got) != len(truth[f]):
            raise AssertionError(f"{name} frame {f}: {len(got)} poses for {len(truth[f])} detections")
        err_after = t_errors(got, f)
        err_before = np.linalg.norm(before[f] - truth[f], axis=1)
        rot = _angles(np.array([p.trafo[:3, :3] for p in got]), np.array([T[:3, :3] for T in expected[f]]))
        return err_before, err_after, np.diag(rot)

    e_before, e_after, e_rot = map(np.concatenate, zip(*(judge("agg8", o, f) for f, o in enumerate(outs))))
    worse = np.flatnonzero(e_after >= e_before)
    if worse.size:
        log(f"  ICP did not lower the error of detections {worse.tolist()}: "
            + ", ".join(f"{a:.2f} -> {b:.2f}" for a, b in zip(e_before[worse], e_after[worse]))
            + f" mm (rotation moved {', '.join(f'{r:.2f}' for r in e_rot[worse])} deg)")
    if worse.size > MAX_WORSE_SHARE * len(e_after):
        raise AssertionError(f"ICP did not lower the error of {worse.size} of {len(e_after)} detections")
    if not np.median(e_after) < 6.0:
        raise AssertionError(f"median translation error after ICP {np.median(e_after):.3f} mm >= 6")
    # the other two recipes run the reference's centred ICP geometry, which
    # leaves a lateral bias off the principal point: reported, not judged
    _, est_after, _ = judge("estimator", out_est, 0)
    _, rs_after, _ = judge("rescore", out_rescore, 0)

    n_det = sum(len(o) for o in outs)
    stages = srv.profile_summary()
    summary = {
        "ms_per_frame": 1e3 * stream_s / len(frames),
        "rescore_ms": rescore_ms, "estimator_ms": estimator_ms,
        "stages_ms": stages, "icp_loop_ms": 1e3 * stream_loop / len(frames),
        "iters": stream_iters, "launches": launches, "stream_launches": stream_launches,
        "t_err_before_mm": float(np.median(e_before)), "t_err_after_mm": float(np.median(e_after)),
        "worse": int(worse.size),
    }
    log(f"  bf16_agg8_frame_icp: {len(frames)} frames x {n_det // len(frames)} detections, "
        f"{summary['ms_per_frame']:.3f} ms/frame (host clock, process_stream)")
    log(f"  translation error (mm), {n_det} detections: before ICP median {np.median(e_before):.3f} "
        f"max {e_before.max():.3f}; after ICP median {np.median(e_after):.3f} max {e_after.max():.3f}, "
        f"lower for {n_det - worse.size} of {n_det}; rotation moved by ICP: median {np.median(e_rot):.3f} "
        f"max {e_rot.max():.3f} deg")
    log(f"  stage split (ms/frame): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    log(f"  icp split (ms/frame): host render + prep {stages['icp'] - summary['icp_loop_ms']:.3f}, "
        f"device loop (upload, iterations, readback) {summary['icp_loop_ms']:.3f}")
    for stage, its in stream_iters.items():
        log(f"  {stage} stage: {len(its)} batched loops, iterations run (slowest lane) mean "
            f"{np.mean(its):.1f} max {max(its)}")
    log(f"  B4 launches per frame: {stream_launches['batched_nn_cuda'] / len(frames):.1f} "
        f"({stream_launches['batched_nn_cuda']} over {len(frames)} frames)")
    log(f"  f32_rescore4_icp frame 0: {rescore_ms:.3f} ms, translation error after ICP median "
        f"{np.median(rs_after):.3f} mm; estimator_f32_top1_icp frame 0: {estimator_ms:.3f} ms, "
        f"median {np.median(est_after):.3f} mm")

    # ---- device busy share over two frames of the stream, under torch.profiler
    if str(device).startswith("cuda"):
        prof = device_profile(lambda: list(srv.process_stream(iter(frames[:2]), depth=2)), n_frames=2)
        summary["profile"] = prof
        if prof is None:
            log("  torch.profiler saw no device time (busy share not measured)")
        else:
            top = ", ".join(f"{k} {v:.3f}" for k, v in prof["top_ms_per_frame"])
            log(f"  bf16_agg8_frame_icp: device busy {prof['device_ms'] / 2:.3f} of "
                f"{prof['wall_ms'] / 2:.3f} ms/frame under the profiler "
                f"({100 * prof['device_ms'] / prof['wall_ms']:.1f}% busy); top: {top}")

    # ---- one single-detection frame per recipe: the same runner on the CPU
    cpu_runners = {
        "bf16_agg8_frame_icp": (srv, PoseServer(cfg_paths["bf16_agg8_frame_icp"], max_dets_per_class=dets,
                                                precision="bfloat16", device="cpu")),
        "f32_rescore4_icp": (rescore, PoseServer(cfg_paths["f32_rescore4_icp"], max_dets_per_class=dets,
                                                 device="cpu")),
        "estimator_f32_top1_icp": (estimator, AePoseEstimator(cfg_paths["estimator_f32_top1_icp"],
                                                              device="cpu")),
    }
    torch.set_num_threads(os.cpu_count() or 1)
    for j, (name, (gpu, cpu)) in enumerate(cpu_runners.items()):
        one = dict(frames[0], bboxes=[frames[0]["bboxes"][j]])
        np.random.seed(10 + j)
        g = gpu.process(**one)[0].trafo
        np.random.seed(10 + j)
        c = cpu.process(**one)[0].trafo
        dt, dr = 1000.0 * float(np.abs(g[:3, 3] - c[:3, 3]).max()), float(np.abs(g[:3, :3] - c[:3, :3]).max())
        if not (dt <= POSE_T_TOL_MM and dr <= POSE_R_TOL):
            raise AssertionError(f"{name}: GPU vs CPU differ by {dt} mm / {dr} in R")
        log(f"  {name}: one-detection frame on GPU equals the CPU port (max |dt| {dt:.2e} mm, "
            f"max |dR| {dr:.2e})")
    return summary


# ------------------------------------------------------------------ phase 6
def embed_experiment(root, template_text, radius=40.0, seed=6):
    """Phase 6's experiment, not yet embedded: a workspace under `root`
    (AE_WORKSPACE_PATH set to it) whose experiment "embed" renders a
    procedural 5,120-face mesh of `radius` mm with seeded f32 weights at
    chkpt-0. Returns (workspace path, cfg, paths)."""
    import torch

    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch import workspace as ws
    from augmentedautoencoder_torch.models import AAE
    from augmentedautoencoder_torch.renderer.procedural import make_textured_asymmetric, save_ply
    from augmentedautoencoder_torch.training.checkpoint import CheckpointManager

    ws_path = os.path.join(root, "workspace")
    os.environ["AE_WORKSPACE_PATH"] = ws_path
    ws.init_workspace(ws_path)
    ply = os.path.join(root, "embed_obj.ply")
    save_ply(make_textured_asymmetric(subdivisions=4, radius=radius), ply)
    with open(ws.get_config_file_path(ws_path, "embed"), "w") as fh:
        fh.write("\n".join(f"MODEL_PATH: {ply}" if line.startswith("MODEL_PATH") else line
                           for line in template_text.splitlines()) + "\n")
    cfg, paths = factory.load_experiment_config("embed")
    torch.manual_seed(seed)
    CheckpointManager(paths["checkpoint_dir"]).save(0, AAE.from_config(cfg, precision="float32").state_dict())
    return ws_path, cfg, paths


def embed_phase(root, device, template_text, radius=40.0, n_retrieve=64, seed=6, batch_size=None,
                profile_views=1024):
    """The codebook build through its entry point, cli.ae_embed.main, at the
    template's width and view count (92,232 views of a procedural
    5,120-face mesh, seeded weights), then its checks: shape, finite unit
    rows and int32 boxes; the checkpoint served by build_codebook_from_name;
    the first batch and the ragged tail encoded again on the CPU from new
    renders (max |dz| <= EMBED_CPU_TOL after normalization, each CPU code's
    top-1 in the device codebook its own row, or a row within MARGIN of its
    cosine: the last in-plane angle of each view repeats its first, 2 pi
    after it); `n_retrieve` seeded views
    rendered again and queried through Codebook.nearest_rotation (B3 on a
    GPU): each returns its own row or one whose cosine is within MARGIN of
    its own. Returns a summary dict; raises on any failed check."""
    import numpy as np
    import torch

    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch.cli import ae_embed
    from augmentedautoencoder_torch.codebook import Codebook
    from augmentedautoencoder_torch.ops import icp_nn
    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.utils import batch_iteration_indices

    ws_path, cfg, paths = embed_experiment(root, template_text, radius, seed)
    argv = ["embed"] + ([] if batch_size is None else ["--batch_size", str(batch_size)])
    bs = batch_size or max(cfg.batch_size, 256)

    # ---- the main path: counts from 0, read right after
    wrappers = (mc.grouped_codebook_top1, mc.grouped_codebook_topk, nq.cosine_top1_cuda,
                icp_nn.batched_nn_cuda)
    for fn in wrappers:
        fn.launches = 0
    split = {}
    t0 = time.perf_counter()
    path = ae_embed.main(argv, device=device, profile=split)
    embed_s = time.perf_counter() - t0
    payload = torch.load(path, map_location="cpu", weights_only=True)
    emb, bbs = payload["embedding_normalized"], payload["embed_obj_bbs"]
    n, latent = factory.embedding_viewsphere(cfg).shape[0], cfg.latent_space_size
    if emb.shape != (n, latent) or emb.dtype != torch.float32 or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"embedding {tuple(emb.shape)} {emb.dtype}, want ({n}, {latent}) finite f32")
    norm_err = float((emb.double().norm(dim=1) - 1.0).abs().max())
    if not norm_err <= 1e-5:
        raise AssertionError(f"embedding rows are not unit: max |norm - 1| {norm_err}")
    if bbs.shape != (n, 4) or bbs.dtype != torch.int32:
        raise AssertionError(f"embed_obj_bbs {tuple(bbs.shape)} {bbs.dtype}, want ({n}, 4) int32")
    cb = factory.build_codebook_from_name("embed", device=device)
    if not (torch.equal(cb.embedding_normalized.cpu(), emb) and np.array_equal(cb.embed_obj_bbs, bbs.numpy())):
        raise AssertionError("build_codebook_from_name does not serve the embedded codebook")
    log(f"  ae_embed: {n} views x {latent} in {embed_s:.1f} s = {n / embed_s:.1f} views/s "
        f"(batch {bs}, {split['batches']} batches); rows unit within {norm_err:.1e}; "
        f"boxes int32; the checkpoint round-trips through build_codebook_from_name")

    # self-retrieval through the served codebook (B3 on a GPU)
    dataset = factory.build_dataset(paths["dataset_path"], cfg)
    rows = np.sort(np.random.RandomState(seed).choice(n, n_retrieve, replace=False))
    crops = np.concatenate([dataset.render_embedding_image_batch(int(r), int(r) + 1)[0] for r in rows])
    got = np.asarray(cb.nearest_rotation(crops, return_idcs=True))
    launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"  main-path launches: {launches}")
    if str(device).startswith("cuda") and launches["cosine_top1_cuda"] < 1:
        raise AssertionError(f"B3 was not launched by the embed path: {launches}")
    z = cb.test_embedding(crops)
    e = emb.numpy()
    own, best = np.sum(z * e[rows], axis=1), np.sum(z * e[got], axis=1)
    miss = (got != rows) & (own < best - MARGIN)
    if miss.any():
        raise AssertionError(f"self-retrieval: rows {rows[miss].tolist()} returned {got[miss].tolist()}")
    log(f"  self-retrieval: {n_retrieve} re-rendered views -> own row {int((got == rows).sum())}, "
        f"a row within {MARGIN} of its own cosine {int((got != rows).sum())}; "
        f"min own cosine {own.min():.6f}")

    # ---- what bounds the render: one batch on 1 thread and on render_workers threads
    per_view = {}
    for w in sorted({1, dataset.render_workers}):
        ds_w = factory.build_dataset(paths["dataset_path"], cfg, renderer=dataset.renderer, render_workers=w)
        ds_w.viewsphere_for_embedding  # computed once per Dataset (~1 s at 92,232 rows): not a render
        t0 = time.perf_counter()
        ds_w.render_embedding_image_batch(0, bs)
        per_view[w] = 1e3 * (time.perf_counter() - t0) / bs
    log("  one batch rendered and cropped: " + ", ".join(f"{ms:.3f} ms/view on {w} thread(s)"
                                                      for w, ms in per_view.items()))

    # ---- the same weights on the CPU, from new renders of the first batch and the ragged tail
    spans = list(batch_iteration_indices(n, bs))
    torch.set_num_threads(os.cpu_count() or 1)
    _, _, cpu_model, _ = factory.restore_experiment("embed", device="cpu", precision="float32")
    encode = factory.make_encode_fn(cpu_model)
    dz = 0.0
    for a, b in sorted({spans[0], spans[-1]}):
        x, box = dataset.render_embedding_image_batch(a, b)
        if not np.array_equal(box.astype(np.int32), bbs[a:b].numpy()):
            raise AssertionError(f"views [{a}, {b}): boxes differ from the embedded ones")
        zc = encode(torch.from_numpy(x)).numpy()
        zc /= np.linalg.norm(zc, axis=1, keepdims=True)
        dz = max(dz, float(np.abs(zc - e[a:b]).max()))
        cos = zc @ e.T
        top, mine = np.argmax(cos, axis=1), np.arange(a, b)
        # the in-plane angles run from 0 to 2 pi inclusive, so the last of
        # each view's NUM_CYCLO rows renders as its first: a tie, not a miss
        miss = (top != mine) & (cos[np.arange(b - a), mine] < cos.max(axis=1) - MARGIN)
        if miss.any():
            raise AssertionError(f"views [{a}, {b}): CPU codes' top-1 {top[miss].tolist()[:8]} "
                                 f"for rows {mine[miss].tolist()[:8]}")
    if not dz <= EMBED_CPU_TOL:
        raise AssertionError(f"GPU vs CPU codes differ by {dz} > {EMBED_CPU_TOL}")
    log(f"  views {spans[0]} and {spans[-1]} encoded on the CPU: max |dz| {dz:.2e}, top-1 own row "
        f"(or its exact duplicate): ok")

    summary = {"workspace": ws_path, "views": n, "seconds": embed_s, "views_per_s": n / embed_s, "split": split,
               "launches": launches, "cpu_count": os.cpu_count(), "render_workers": dataset.render_workers,
               "gpu_cpu_max_dz": dz, "render_ms_per_view": per_view}
    nb = split["batches"]
    log(f"  split (s): render thread {split['render']:.1f}, host wait on the render future "
        f"{split['wait']:.1f}, H2D {split['h2d']:.3f} (device), encode {split['encode']:.2f} (device; "
        f"{1e3 * split['encode'] / nb:.3f} ms/batch), readback {split['readback']:.3f}, total "
        f"{split['total']:.1f}; host os.cpu_count() {os.cpu_count()}, render_workers {dataset.render_workers}")

    # ---- device busy share over a few batches of the same build, under torch.profiler
    if str(device).startswith("cuda"):
        _, _, model, _ = factory.restore_experiment("embed", device=device, precision="float32")
        prof = device_profile(lambda: Codebook.build_embedding(
            factory.make_encode_fn(model), dataset.render_embedding_image_batch, profile_views, bs,
            progress=False, device=device), n_frames=-(-profile_views // bs))
        summary["profile"] = prof
        if prof is None:
            log("  torch.profiler saw no device time (busy share not measured)")
        else:
            top = ", ".join(f"{k} {v:.3f}" for k, v in prof["top_ms_per_frame"])
            log(f"  {profile_views} views under the profiler: device busy {prof['device_ms']:.1f} of "
                f"{prof['wall_ms']:.1f} ms ({100 * prof['device_ms'] / prof['wall_ms']:.1f}% busy); "
                f"top (ms/batch): {top}")
    return summary



def _to(tree, device):
    """A nested dict / list of tensors moved to `device` (other leaves kept)."""
    import torch

    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def train_step_flops(cfg) -> float:
    """FLOPs of one training step's convolutions and matmuls (forward and
    backward) at cfg's shapes and batch, counted by
    torch.utils.flop_counter on meta tensors (no device work)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from augmentedautoencoder_torch.models import AAE

    with torch.device("meta"):
        model = AAE.from_config(cfg, train=True).train()
        x = torch.empty((cfg.batch_size,) + tuple(cfg.shape))
        with FlopCounterMode(display=False) as counter:
            model(x, x, train=True).total_loss.backward()
    return float(counter.get_total_flops())


@contextlib.contextmanager
def plain_decoder():
    """Within it, the decoder's 2x steps upsample, then convolve
    (`upsample2x_conv_plain`): the port's decoder before the fused form."""
    from augmentedautoencoder_torch.models import decoder
    from augmentedautoencoder_torch.ops import fused_upconv

    fused, decoder.upsample2x_conv = decoder.upsample2x_conv, fused_upconv.upsample2x_conv_plain
    try:
        yield
    finally:
        decoder.upsample2x_conv = fused


def upconv_phase(root, template_text, batch=64, reps=10, seed=11, steps=12):
    """The decoder's fused 2x convolution (`ops.fused_upconv.upsample2x_conv`)
    against its plain form on the card at the decoder's four 2x shapes of
    the template at batch `batch`, on operands rounded to bf16 (so the f32
    and the bf16 forms take the same values): in f32 without TF32, the
    forward and the gradients of x, w and b within UPCONV_RTOL of each
    tensor's largest |value| in the plain form computed in f64 (the plain
    form in f32 printed beside it); in bf16, the fused and the plain form
    each within UPCONV_BF16_RTOL of the same f64; each form's device ms
    (forward; forward + backward) in both precisions.
    Then one full-width f32 training step (forward, backward, optimizer)
    under each decoder: its ms (median of `steps`, synchronized), its FLOPs
    and its peak allocated memory. Returns a summary dict."""
    import numpy as np
    import torch

    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch.config import load_train_config
    from augmentedautoencoder_torch.ops import fused_upconv as fu
    from augmentedautoencoder_torch.training import make_optimizer

    gen = torch.Generator(device="cuda").manual_seed(seed)
    summary = {"shapes": []}

    def rel(a, p):
        return {k: float((u.double() - v.double()).abs().max() / v.double().abs().max())
                for k, u, v in zip(("y", "dx", "dw", "db"), a, p)}

    for hw, cin, cout in UPCONV_SHAPES:
        x, w, b, g = (t.bfloat16().float() for t in (
            torch.rand((batch, cin, hw, hw), generator=gen, device="cuda"),
            torch.randn((cout, cin, 5, 5), generator=gen, device="cuda") / (5 * cin ** 0.5),
            torch.randn((cout,), generator=gen, device="cuda"),
            torch.randn((batch, cout, 2 * hw, 2 * hw), generator=gen, device="cuda")))
        got = {}
        for name, fn, dt in (("fused", fu.upsample2x_conv, torch.float32), ("plain", fu.upsample2x_conv_plain, torch.float32),
                             ("fused_bf16", fu.upsample2x_conv, torch.bfloat16),
                             ("plain_bf16", fu.upsample2x_conv_plain, torch.bfloat16),
                             ("f64", fu.upsample2x_conv_plain, torch.float64)):
            xs, ws, bs = (t.detach().to(dt, copy=True).requires_grad_() for t in (x, w, b))
            y = fn(xs, ws, bs)
            y.backward(g.to(dt))
            got[name] = (y.detach(), xs.grad, ws.grad, bs.grad)
            del xs, ws, bs, y

        errs, against = rel(got["fused"], got["f64"]), {"plain": rel(got["plain"], got["f64"]),
                                                        "fused_vs_plain": rel(got["fused"], got["plain"])}
        bf16 = {"fused": rel(got["fused_bf16"], got["f64"]), "plain": rel(got["plain_bf16"], got["f64"]),
                "fused_vs_plain": rel(got["fused_bf16"], got["plain_bf16"])}
        del got

        def fwd(fn, dt):
            xd, wd, bd = x.to(dt), w.to(dt), b.to(dt)
            return lambda: (fn(xd, wd, bd),)

        def fwd_bwd(fn, dt):
            xs, ws, bs = (t.to(dt).requires_grad_() for t in (x, w, b))
            gd = g.to(dt)

            def run():
                y = fn(xs, ws, bs)
                y.backward(gd)
                return (y.detach(),)
            return run

        fns = {}
        for tag, dt in (("", torch.float32), ("_bf16", torch.bfloat16)):
            for form, fn in (("fused", fu.upsample2x_conv), ("plain", fu.upsample2x_conv_plain)):
                fns[form + tag] = fwd(fn, dt)
                fns[form + "_fb" + tag] = fwd_bwd(fn, dt)
        t = time_fns(fns, reps)
        shape = f"{hw}->{2 * hw}, {cin}->{cout}"
        log(f"  fused 2x conv at {shape} (batch {batch}), max |d| / max |f64| against the plain form in f64: "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + "; the plain form in f32: "
            + ", ".join(f"{k} {v:.2e}" for k, v in against["plain"].items()) + "; fused vs plain f32: "
            + ", ".join(f"{k} {v:.2e}" for k, v in against["fused_vs_plain"].items())
            + f"; device ms forward {t['fused']:.3f} vs {t['plain']:.3f}, forward + backward "
              f"{t['fused_fb']:.3f} vs {t['plain_fb']:.3f}")
        log(f"    in bf16: fused against f64 " + ", ".join(f"{k} {v:.2e}" for k, v in bf16["fused"].items())
            + "; plain against f64 " + ", ".join(f"{k} {v:.2e}" for k, v in bf16["plain"].items())
            + "; fused vs plain " + ", ".join(f"{k} {v:.2e}" for k, v in bf16["fused_vs_plain"].items())
            + f"; device ms forward {t['fused_bf16']:.3f} vs {t['plain_bf16']:.3f}, forward + backward "
              f"{t['fused_fb_bf16']:.3f} vs {t['plain_fb_bf16']:.3f}")
        if not max(errs.values()) <= UPCONV_RTOL:
            raise AssertionError(f"fused 2x conv at {shape} against the plain form in f64: {errs}, "
                                 f"want each <= {UPCONV_RTOL}")
        worst_bf16 = max(max(bf16["fused"].values()), max(bf16["plain"].values()))
        if not worst_bf16 <= UPCONV_BF16_RTOL:
            raise AssertionError(f"bf16 2x conv at {shape} against f64: fused {bf16['fused']}, plain "
                                 f"{bf16['plain']}, want each <= {UPCONV_BF16_RTOL}")
        summary["shapes"].append({"shape": shape, "errs": errs, **against, "bf16": bf16, "ms": t})
        del x, w, b, g, fns

    os.makedirs(root)
    cfg_path = os.path.join(root, "template.cfg")
    with open(cfg_path, "w") as fh:
        fh.write(template_text)
    cfg = load_train_config(cfg_path)
    x = torch.rand((cfg.batch_size,) + tuple(cfg.shape), generator=gen, device="cuda")
    y = torch.rand((cfg.batch_size,) + tuple(cfg.shape), generator=gen, device="cuda")
    for name in ("fused", "plain"):
        with (plain_decoder() if name == "plain" else contextlib.nullcontext()):
            flops = train_step_flops(cfg)
            model = factory.build_train_model(cfg, "cuda")
            model.train()
            optim = make_optimizer(model, cfg)
            times = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(steps):
                t0 = time.perf_counter()
                optim.zero_grad()
                model(x, y, train=True).total_loss.backward()
                optim.step()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = 1e3 * float(np.median(times[2:]))
        summary[name] = {"step_ms": ms, "flops": flops, "peak_gib": peak}
        log(f"  one full-width step ({cfg.batch_size} x {cfg.h}x{cfg.w}x{cfg.c}, forward, backward, Adam; "
            f"median of {steps - 2}, synchronized) with the {name} decoder: {ms:.3f} ms, {flops / 1e12:.3f} TFLOP "
            f"({flops / ms / 1e9:.1f} TFLOP/s), peak allocated {peak:.2f} GiB")
        del model, optim
    return summary


def step_split(tr, steps):
    """The trainer's step split into sample_batch / forward_backward /
    optimizer by the port's StageTimer, each stage closed by a synchronize:
    mean ms of `steps` steps, printed and returned."""
    import torch

    from augmentedautoencoder_torch.training.profiler import StageTimer

    timer = StageTimer()
    tr.model.train()
    for i in range(steps):
        gen = tr.generator_for(10 ** 7 + i)
        torch.cuda.synchronize()
        with timer.stage("sample_batch"):
            xb, yb = tr.dataset.sample_batch(gen, tr.cfg.batch_size)
            torch.cuda.synchronize()
        with timer.stage("forward_backward"):
            out = tr.model(xb, yb, train=True, generator=gen)
            tr.optimizer.zero_grad()
            out.total_loss.backward()
            torch.cuda.synchronize()
        with timer.stage("optimizer"):
            tr.optimizer.step()
            torch.cuda.synchronize()
    split = {k: 1e3 * v["mean_s"] for k, v in timer.summary().items()}
    log(f"  step split over {steps} steps (ms, mean, synchronized): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f"; sum {sum(split.values()):.3f}")
    return split


def step_profile(tr, steps, trace_dir):
    """`steps` of the trainer's steps under the port's training.profiler.trace:
    device_profile's dict (or None)."""
    return device_profile(lambda: [tr.step_fn(tr.generator_for(10 ** 8 + i)) for i in range(steps)],
                          n_frames=steps, top=8, trace_dir=trace_dir)


def train_phase(root, device, template_text, n_train=4096, n_bg=1000, num_iter=200, save_interval=100,
                seed=7, radius=40.0, parity_batch=8, split_steps=10, profile_steps=10, timed_from=50):
    """Training through its entry point, cli.ae_train.main, at the template's
    width (a procedural 5,120-face mesh; NOOF_TRAINING_IMGS cut to
    `n_train`, NOOF_BG_IMGS to `n_bg` seeded backgrounds written as PNG
    files and as the .npy cache load_bg_images reads), then its checks: the
    logged losses finite and falling (mean of the last 5 below the first
    5); chkpt-<save_interval> and chkpt-<num_iter> written, the first
    restored bit for bit (step, parameters, statistics, optimizer state)
    and one more step taken from it; one step of batch `parity_batch` on
    `device` and on the CPU from the same state and batch (loss within
    TRAIN_LOSS_RTOL, gradients within TRAIN_GRAD_RTOL, the update from the
    card's gradients within TRAIN_PARAM_TOL); compose_batch
    on `device` and on the CPU from the same draws (composites equal,
    augmented batch within TRAIN_AUG_TOL); the trained checkpoint served by
    restore_experiment, encoding as the trainer's model. Returns a summary
    dict; raises on any failed check."""
    import numpy as np
    import torch

    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch import workspace as ws
    from augmentedautoencoder_torch.cli import ae_train
    from augmentedautoencoder_torch.data import augment_spec
    from augmentedautoencoder_torch.data.occlusion_masks import synthesize_mask_bank
    from augmentedautoencoder_torch.data.pipeline import DeviceDataset
    from augmentedautoencoder_torch.ops import icp_nn
    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.renderer.procedural import make_textured_asymmetric, save_ply
    from augmentedautoencoder_torch.training import CheckpointManager, Trainer, make_optimizer
    from augmentedautoencoder_torch.utils.png import write_png

    cuda = str(device).startswith("cuda")
    ws_path = os.path.join(root, "workspace")
    os.environ["AE_WORKSPACE_PATH"] = ws_path
    ws.init_workspace(ws_path)
    ply = os.path.join(root, "train_obj.ply")
    save_ply(make_textured_asymmetric(subdivisions=4, radius=radius), ply)
    bg_dir = os.path.join(root, "backgrounds")
    os.makedirs(bg_dir)
    subs = {"MODEL_PATH": ply, "BACKGROUND_IMAGES_GLOB": os.path.join(bg_dir, "*.png"),
            "NOOF_TRAINING_IMGS": n_train, "NOOF_BG_IMGS": n_bg, "NUM_ITER": num_iter,
            "SAVE_INTERVAL": save_interval}
    lines = []
    for line in template_text.splitlines():
        key = line.split(":")[0].strip()
        lines.append(f"{key}: {subs[key]}" if key in subs else line)
    with open(ws.get_config_file_path(ws_path, "train"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    cfg, paths = factory.load_experiment_config("train")
    rng = np.random.RandomState(seed)
    bgs = rng.randint(0, 256, (n_bg,) + cfg.shape, dtype=np.uint8)
    for i, img in enumerate(bgs):
        write_png(os.path.join(bg_dir, f"{i:05d}.png"), img)
    cache = factory.build_dataset(paths["dataset_path"], cfg).bg_cache_file(paths["dataset_path"])
    os.makedirs(paths["dataset_path"], exist_ok=True)
    np.save(cache, bgs)
    import importlib.util

    log(f"  PIL on this machine: {'yes' if importlib.util.find_spec('PIL') else 'no'} (without it the "
        f"backgrounds come from the .npy cache only); tensorboard: "
        f"{'yes' if importlib.util.find_spec('tensorboard') else 'no'} (with it the timed run also writes "
        f"event files)")
    log(f"  cfg: {cfg.h}x{cfg.w}x{cfg.c}, filters {cfg.num_filter}, latent {cfg.latent_space_size}, batch "
        f"{cfg.batch_size}, {cfg.loss} bootstrap {cfg.bootstrap_ratio}, {cfg.optimizer} {cfg.learning_rate}; "
        f"cut: NOOF_TRAINING_IMGS 20000 -> {n_train}, NOOF_BG_IMGS 15000 -> {n_bg} seeded backgrounds "
        f"(PNG files and the .npy cache), NUM_ITER -> {num_iter}, SAVE_INTERVAL -> {save_interval}")

    # the training renders, through the entry point (-gen: renders and the .npz cache)
    t0 = time.perf_counter()
    ae_train.main(["train", "-gen", "--seed", str(seed)], device=device)
    gen_s = time.perf_counter() - t0
    # the renders alone, on the render threads and on one
    probe = factory.build_dataset(paths["dataset_path"], cfg)
    workers, per_pair = probe.render_workers, {}
    for w in sorted({workers, 1}):
        ds_w = factory.build_dataset(paths["dataset_path"], cfg, renderer=probe.renderer, render_workers=w)
        ds_w.noof_training_imgs = n_probe = min(n_train, 512)
        t0 = time.perf_counter()
        ds_w.render_training_images(np.random.RandomState(seed), progress=False)
        per_pair[w] = (time.perf_counter() - t0) / n_probe
    log(f"  training renders: -gen {n_train} pairs and the cache in {gen_s:.1f} s ({n_train / gen_s:.1f} pairs/s); "
        f"{n_probe} pairs rendered and cropped: " + ", ".join(f"{1 / t:.1f} pairs/s on {w} thread(s)"
                                                         for w, t in per_pair.items())
        + f" (host os.cpu_count() {os.cpu_count()})")
    render_pairs_per_s = 1 / per_pair[workers]

    # ---- the main path: counts from 0, read right after
    wrappers = (mc.grouped_codebook_top1, mc.grouped_codebook_topk, nq.cosine_top1_cuda, icp_nn.batched_nn_cuda)
    for fn in wrappers:
        fn.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = ae_train.main(["train", "--seed", str(seed)], device=device)
    train_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"  main-path launches: {launches}")
    ends = np.asarray(trainer.step_end_times)
    step_ms = float(np.median(np.diff(ends[timed_from - 1:]))) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    log(f"  ae_train: {trainer.step} steps in {train_s:.1f} s (load, {trainer.step} steps, 2 saves); "
        f"{step_ms:.3f} ms/step (median of steps {timed_from}-{num_iter}, host clock, losses read back at "
        f"the deferred flushes only); device dataset {trainer.dataset.nbytes() / 2**20:.1f} MiB, peak "
        f"allocated {peak:.2f} GiB")

    flops = train_step_flops(trainer.dataset.cfg)
    log(f"  one step's convolutions and matmuls (torch.utils.flop_counter on meta tensors): {flops / 1e12:.3f} "
        f"TFLOP; at {step_ms:.3f} ms/step {flops / step_ms / 1e9:.1f} TFLOP/s = "
        f"{100 * flops / step_ms / 1e-3 / F32_FLOPS:.1f}% of the f32 peak ({F32_FLOPS / 1e12:.0f} TFLOP/s, 700 W)")

    with open(os.path.join(paths["checkpoint_dir"], "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    total = np.array([r["total_loss"] for r in rows])
    if not (len(total) >= 10 and np.isfinite(total).all()):
        raise AssertionError(f"logged losses: {total.tolist()}")
    first, last = float(total[:5].mean()), float(total[-5:].mean())
    if not last < first:
        raise AssertionError(f"the loss did not fall: first 5 logged {total[:5].tolist()}, last 5 {total[-5:].tolist()}")
    log(f"  losses: {len(total)} logged, all finite; mean of the first 5 {first:.6f}, of the last 5 {last:.6f}")

    # ---- checkpoints: chkpt-<save_interval> restored bit for bit, one more step from it
    mgr = CheckpointManager(paths["checkpoint_dir"])
    if not {save_interval, num_iter} <= set(mgr.all_steps()):
        raise AssertionError(f"checkpoints {mgr.all_steps()}, want {save_interval} and {num_iter}")
    saved = torch.load(mgr.path_for_step(save_interval), map_location="cpu", weights_only=True)
    resumed = Trainer(cfg, trainer.dataset, seed=seed)
    payload = mgr.restore_train_state(resumed.model, resumed.optimizer, at_step=save_interval)
    resumed.step = int(payload["step"])
    state = resumed.model.state_dict()
    want = {**saved["params"], **saved["batch_stats"], **saved["decoder"]}
    opt = resumed.optimizer.state_dict()
    same = (resumed.step == saved["step"] == save_interval and set(state) == set(want)
            and all(torch.equal(state[k].cpu(), v) for k, v in want.items())
            and torch.equal(opt["count"], saved["opt_state"]["count"])
            and all(torch.equal(opt["slots"][s][k], v) for s, d in saved["opt_state"]["slots"].items()
                    for k, v in d.items()))
    if not same:
        raise AssertionError(f"chkpt-{save_interval} did not restore bit for bit")
    resumed.train(num_iter=save_interval + 1, progress=False)
    if resumed.step != save_interval + 1 or int(resumed.optimizer.count) != save_interval + 1:
        raise AssertionError(f"the step after the restore: step {resumed.step}")
    log(f"  chkpt-{save_interval} and chkpt-{num_iter} written; chkpt-{save_interval} restored bit for bit "
        f"(step, {len(want)} tensors, {sum(len(d) for d in opt['slots'].values())} optimizer slots, count "
        f"{int(opt['count'])}); one more step from it: ok")

    # ---- one step of batch `parity_batch` on the device and on the CPU from the same state and batch
    state = {k: v.detach().cpu().clone() for k, v in resumed.model.state_dict().items()}
    opt = _to(resumed.optimizer.state_dict(), "cpu")
    opt = {"name": opt["name"], "count": opt["count"].clone(),
           "slots": {s: {k: v.clone() for k, v in d.items()} for s, d in opt["slots"].items()}}
    x, y = trainer.dataset.sample_batch(resumed.generator_for(10 ** 6), parity_batch)
    x, y = x.cpu(), y.cpu()

    def restored(dev):
        model = factory.build_train_model(cfg, dev)
        model.load_state_dict(state)
        optim = make_optimizer(model, cfg)
        optim.load_state_dict(opt)
        return model, optim

    steps = {}
    for dev in (device, "cpu"):
        model, optim = restored(dev)
        model.train()
        out = model(x.to(dev), y.to(dev), train=True)
        optim.zero_grad()
        out.total_loss.backward()
        grads = {k: v.grad.detach().cpu().clone() for k, v in model.named_parameters()}
        optim.step()
        steps[dev] = (out.total_loss.item(), grads, {k: v.detach().cpu() for k, v in model.named_parameters()})
    (loss_d, g_d, p_d), (loss_c, g_c, p_c) = steps[device], steps["cpu"]
    # the update alone: the CPU optimizer given the card's gradients
    model, optim = restored("cpu")
    for k, v in model.named_parameters():
        v.grad = g_d[k].clone()
    optim.step()
    p_upd = {k: v.detach() for k, v in model.named_parameters()}
    loss_rel = abs(loss_d - loss_c) / abs(loss_c)
    dg = {k: float((g_d[k] - g_c[k]).abs().max() / g_c[k].abs().max().clamp_min(1e-30)) for k in g_c}
    dp = {k: float((p_d[k] - p_upd[k]).abs().max()) for k in p_c}
    own = max(float((p_d[k] - p_c[k]).abs().max()) for k in p_c)
    moved = max(float((p_upd[k] - state[k]).abs().max()) for k in p_c)
    worst_g = sorted(dg.items(), key=lambda kv: -kv[1])
    worst = sorted(dp.items(), key=lambda kv: -kv[1])
    log(f"  one step of batch {parity_batch}, {device} vs CPU from chkpt-{save_interval}'s state (TF32 off): loss "
        f"{loss_d:.7f} vs {loss_c:.7f} (rel {loss_rel:.2e}); max |dgrad| / max |grad| per tensor: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst_g) + "; the update, the CPU optimizer given the card's "
        "gradients, max |dparam| per tensor: " + ", ".join(f"{k} {v:.2e}" for k, v in worst)
        + f"; the step moved parameters by up to {moved:.2e}; each device's own step: max |dparam| {own:.2e}")
    if not loss_rel <= TRAIN_LOSS_RTOL or not worst_g[0][1] <= TRAIN_GRAD_RTOL or not worst[0][1] <= TRAIN_PARAM_TOL:
        raise AssertionError(f"{device} vs CPU train step: loss rel {loss_rel}, max |dgrad| / max |grad| "
                             f"{worst_g[0]}, max |dparam| {worst[0]}")

    # ---- compose_batch from the same draws on the device and on the CPU: the
    # template's chain, then every occlusion / clutter option and augmentation op
    ds = trainer.dataset
    arrays = [a.cpu().numpy() for a in (ds.train_x, ds.mask_x, ds.train_y, ds.bg_imgs, ds.noof_obj_pixels)]
    # ds.cfg, not cfg: every parse of the template draws its GaussianBlur
    # sigma anew (`1.2*np.random.rand()`, as in the reference)
    options_cfg = dataclasses.replace(
        ds.cfg, realistic_occlusion=0.3, square_occlusion=0.3, neighbor_clutter=0.5, neighbor_clutter_count=2,
        code=eval(ALL_OPS_CODE, dict(augment_spec.DSL_CONSTRUCTORS)))
    occluders = synthesize_mask_bank(64, (cfg.h, cfg.w), seed=seed)
    aug_errs = {}
    for name, c, occ in (("template", ds.cfg, None), ("every option and op", options_cfg, occluders)):
        dev_ds = ds if occ is None else DeviceDataset(c, *arrays, occlusion_masks=occ, device=device)
        cpu_ds = DeviceDataset(c, *arrays, occlusion_masks=occ, device="cpu")
        draws = dev_ds.draw_batch(resumed.generator_for(10 ** 6 + 1), cfg.batch_size)
        cpu_draws = _to(draws, "cpu")
        comp_equal = all(torch.equal(a.cpu(), b) for a, b in zip(dev_ds.composite(draws), cpu_ds.composite(cpu_draws)))
        aug_errs[name] = float((dev_ds.compose_batch(draws)[0].cpu() - cpu_ds.compose_batch(cpu_draws)[0]).abs().max())
        log(f"  compose_batch ({name}), {device} vs CPU from the same draws (batch {cfg.batch_size}): uint8 "
            f"composites {'equal' if comp_equal else 'DIFFER'}; augmented max |dx| {aug_errs[name]:.2e}")
        if not comp_equal or not aug_errs[name] <= TRAIN_AUG_TOL:
            raise AssertionError(f"compose_batch ({name}) {device} vs CPU: composites equal {comp_equal}, "
                                 f"aug err {aug_errs[name]}")
        del dev_ds, cpu_ds
    aug_err = max(aug_errs.values())

    # ---- the trained checkpoint, served
    _, _, served, payload = factory.restore_experiment("train", device=device)
    trainer.model.eval()
    with torch.no_grad():
        xb = ds.sample_batch(resumed.generator_for(10 ** 6 + 2), cfg.batch_size)[0]
        dz = float((served.encode(xb) - trainer.model.encode(xb)).abs().max())
    if payload["step"] != num_iter or not dz <= TRAIN_SERVE_TOL:
        raise AssertionError(f"chkpt-{num_iter} served: step {payload['step']}, max |dz| {dz}")
    log(f"  chkpt-{num_iter} served by restore_experiment: max |dz| {dz:.2e} against the trainer's encoder")

    summary = {"launches": launches, "step_ms": step_ms, "step_flops": flops, "render_pairs_per_s": render_pairs_per_s,
               "gen_s": gen_s, "render_workers": workers, "loss_first5": first, "loss_last5": last, "gpu_cpu_loss_rel": loss_rel,
               "gpu_cpu_max_dgrad_rel": worst_g[0][1], "gpu_cpu_max_dparam": worst[0][1], "own_step_max_dparam": own,
               "aug_err": aug_err, "serve_dz": dz}
    if not cuda:
        return summary

    # ---- the step split into its stages (the port's StageTimer), each closed by a synchronize
    tr = resumed
    summary["split_ms"] = step_split(tr, split_steps)
    # the busy share under the port's training.profiler.trace
    prof = step_profile(tr, profile_steps, os.path.join(root, "trace"))
    summary["profile"] = prof
    if prof is None:
        log("  torch.profiler saw no device time (busy share not measured)")
    else:
        top = ", ".join(f"{k} {v:.3f}" for k, v in prof["top_ms_per_frame"])
        log(f"  {profile_steps} steps under the profiler: device busy {prof['device_ms']:.1f} of "
            f"{prof['wall_ms']:.1f} ms ({100 * prof['device_ms'] / prof['wall_ms']:.1f}% busy); "
            f"top (ms/step): {top}")
    return summary


def _grads_of(model, x, y):
    """(total loss, {parameter: gradient as f64 on the CPU}) of one training
    forward and backward of `model` on (x, y)."""
    model.train()
    out = model(x, y, train=True)
    model.zero_grad()
    out.total_loss.backward()
    return out.total_loss.item(), {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}


def bf16_train_phase(root, device, f32_summary, num_iter=200, save_interval=100, seed=7, parity_batch=8,
                     split_steps=10, profile_steps=10, timed_from=50):
    """Phase 7's bf16 arm: the f32 phase's experiment again with PRECISION
    bfloat16 (the same workspace, renders and backgrounds; f32 parameters,
    bf16 convolutions and denses, f32 heads, loss and optimizer), trained
    through cli.ae_train.main for `num_iter` steps. Checks the logged losses
    finite and falling, the model's and every checkpoint's tensors f32,
    and one step of batch `parity_batch` on `device` and on the CPU from
    the trained state, each against the same step in f64 on `device`
    (BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_L2). Prints ms/step (median of
    steps `timed_from`-`num_iter`, host clock, losses read back at the
    deferred flushes only) beside the f32 step's, the step's FLOPs, TFLOP/s,
    peak memory and, on the card, its split and busy share."""
    import numpy as np
    import torch

    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch import workspace as ws
    from augmentedautoencoder_torch.cli import ae_train
    from augmentedautoencoder_torch.models.reference import float64_loss, float64_model
    from augmentedautoencoder_torch.ops import icp_nn
    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.training import CheckpointManager

    cuda = str(device).startswith("cuda")
    ws_path = ws.get_workspace_path()
    with open(ws.get_config_file_path(ws_path, "train")) as fh:
        text = fh.read()
    with open(ws.get_config_file_path(ws_path, "train_bf16"), "w") as fh:
        fh.write(text.replace("[Training]\n", "[Training]\nPRECISION: bfloat16\n", 1))
    cfg, paths = factory.load_experiment_config("train_bf16")
    if cfg.precision != "bfloat16" or (cfg.num_iter, cfg.save_interval) != (num_iter, save_interval):
        raise AssertionError(f"bf16 cfg: {cfg.precision}, {cfg.num_iter} steps, saves every {cfg.save_interval}")

    # ---- the main path: counts from 0, read right after
    wrappers = (mc.grouped_codebook_top1, mc.grouped_codebook_topk, nq.cosine_top1_cuda, icp_nn.batched_nn_cuda)
    for fn in wrappers:
        fn.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = ae_train.main(["train_bf16", "--seed", str(seed)], device=device)
    train_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    ends = np.asarray(trainer.step_end_times)
    step_ms = float(np.median(np.diff(ends[timed_from - 1:]))) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    flops = train_step_flops(cfg)
    f32_ms = f32_summary["step_ms"]
    log(f"  main-path launches: {launches}")
    log(f"  ae_train in bf16: {trainer.step} steps in {train_s:.1f} s (load, {trainer.step} steps, 2 saves); "
        f"{step_ms:.3f} ms/step against the f32 step's {f32_ms:.3f} ms/step ({f32_ms / step_ms:.2f}x; each the "
        f"median of steps {timed_from}-{num_iter}, host clock); {flops / 1e12:.3f} TFLOP a step, "
        f"{flops / step_ms / 1e9:.1f} TFLOP/s = {100 * flops / step_ms / 1e-3 / BF16_FLOPS:.1f}% of the dense bf16 "
        f"peak ({BF16_FLOPS / 1e12:.0f} TFLOP/s, 700 W); peak allocated {peak:.2f} GiB")

    with open(os.path.join(paths["checkpoint_dir"], "metrics.jsonl")) as fh:
        total = np.array([json.loads(line)["total_loss"] for line in fh])
    if not (len(total) >= 10 and np.isfinite(total).all()):
        raise AssertionError(f"bf16 logged losses: {total.tolist()}")
    first, last = float(total[:5].mean()), float(total[-5:].mean())
    if not last < first:
        raise AssertionError(f"the bf16 loss did not fall: first 5 logged {total[:5].tolist()}, last 5 "
                             f"{total[-5:].tolist()}")
    mgr = CheckpointManager(paths["checkpoint_dir"])
    f32_only = all(t.dtype == torch.float32 for t in trainer.model.state_dict().values() if t.is_floating_point())
    for step in mgr.all_steps():
        payload = mgr.restore(step)
        tensors = [*payload["state_dict"].values(), *payload["decoder"].values(),
                   *(t for d in payload["opt_state"]["slots"].values() for t in d.values())]
        f32_only &= all(t.dtype == torch.float32 for t in tensors if t.is_floating_point())
    if mgr.all_steps() != [save_interval, num_iter] or not f32_only:
        raise AssertionError(f"bf16 checkpoints {mgr.all_steps()}, every tensor f32: {f32_only}")
    log(f"  losses: {len(total)} logged, all finite; mean of the first 5 {first:.6f}, of the last 5 {last:.6f}; "
        f"parameters, statistics and optimizer slots f32 in the model and in chkpt-{save_interval}, "
        f"chkpt-{num_iter}")

    # ---- one step of batch `parity_batch` on the device and on the CPU, each against f64
    state = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    x, y = (t.cpu() for t in trainer.dataset.sample_batch(trainer.generator_for(10 ** 6), parity_batch))

    def model_on(dev):
        model = factory.build_train_model(cfg, dev)
        model.load_state_dict(state)
        return model

    with float64_loss():
        loss64, g64 = _grads_of(float64_model(model_on(device)), x.double().to(device), y.double().to(device))
    parity = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        loss, g = _grads_of(model_on(dev), x.to(dev), y.to(dev))
        l2 = {k: float((g[k] - g64[k]).norm() / g64[k].norm().clamp_min(1e-300)) for k in g64}
        mx = {k: float((g[k] - g64[k]).abs().max() / g64[k].abs().max().clamp_min(1e-300)) for k in g64}
        parity[dev] = {"loss_rel": abs(loss - loss64) / abs(loss64), "grad_l2": l2, "grad_max": mx,
                       "s": time.perf_counter() - t0}
        worst = sorted(l2.items(), key=lambda kv: -kv[1])
        log(f"  one bf16 step of batch {parity_batch} on {dev} against f64 on {device}, the trained state: loss "
            f"{loss:.7f} vs {loss64:.7f} (rel {parity[dev]['loss_rel']:.2e}); |dgrad|_2 / |grad|_2 per tensor: "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst) + "; max |dgrad| / max |grad| at most "
            + f"{max(mx.values()):.2e} ({max(mx, key=mx.get)}); {parity[dev]['s']:.1f} s")
        if not parity[dev]["loss_rel"] <= BF16_STEP_LOSS_RTOL or not worst[0][1] <= BF16_STEP_GRAD_L2:
            raise AssertionError(f"bf16 step on {dev} against f64: loss rel {parity[dev]['loss_rel']}, "
                                 f"gradient {worst[0]}")

    summary = {"launches": launches, "step_ms": step_ms, "f32_step_ms": f32_ms, "step_flops": flops,
               "peak_gib": peak, "loss_first5": first, "loss_last5": last,
               "parity": {d: {k: v for k, v in p.items() if k != "grad_max"} for d, p in parity.items()}}
    if not cuda:
        return summary
    summary["split_ms"] = step_split(trainer, split_steps)
    log(f"  the f32 step's split in this run: " + ", ".join(f"{k} {v:.3f}" for k, v in f32_summary["split_ms"].items()))
    prof = step_profile(trainer, profile_steps, os.path.join(root, "trace_bf16"))
    summary["profile"] = prof
    if prof is None:
        log("  torch.profiler saw no device time (busy share not measured)")
    else:
        top = ", ".join(f"{k} {v:.3f}" for k, v in prof["top_ms_per_frame"])
        log(f"  {profile_steps} bf16 steps under the profiler: device busy {prof['device_ms']:.1f} of "
            f"{prof['wall_ms']:.1f} ms ({100 * prof['device_ms'] / prof['wall_ms']:.1f}% busy); "
            f"top (ms/step): {top}")
    return summary


# ------------------------------------------------------------------ phase 8
def _view_rotation(box, K, R_view):
    """The rotation an object whose box is `box` (x, y, w, h) has when it
    looks as the centred codebook view R_view does: the codebook's
    off-centre correction (`Codebook._solve_6d`) for a detection of that
    box, whose angles depend on the box centre only."""
    import numpy as np

    x, y, w, h = (float(v) for v in box)
    tx, ty = (x + w / 2.0 - K[0, 2]) / K[0, 0], (y + h / 2.0 - K[1, 2]) / K[1, 1]
    d_ay, d_ax = np.arctan(tx / np.sqrt(1.0 + ty ** 2)), -np.arctan(ty)
    ca, sa, cb, sb = np.cos(d_ax), np.sin(d_ax), np.cos(d_ay), np.sin(d_ay)
    R_x = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    R_y = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    return R_y @ R_x @ R_view


def _mask_box(mask):
    import numpy as np

    ys, xs = np.nonzero(mask)
    return [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)]


def write_eval_scene(scene_dir, renderer, K, hw, views, rows, rng, instances=3, z_range=(700.0, 800.0),
                     lateral=0.25, n_images=24):
    """A BOP scene of `n_images` images of `instances` objects each, written
    by the port's PNG writer: seeded noise backgrounds with the objects
    z-buffered over them (rgb), 16-bit depth in mm, mask_visib,
    scene_gt.json, scene_camera.json and scene_gt_info.json (bbox_obj,
    bbox_visib, visib_fract). Instance j of image i sits at a depth in
    z_range, `lateral` x the frame's width apart, with its rotation the
    codebook view rows[i, j] turned for its box (`_view_rotation`, iterated
    until the rendered box stops moving), so that the codebook pose of its
    box has its GT rotation. Returns [(R, t, box)] per image."""
    import numpy as np

    from augmentedautoencoder_torch.utils.png import write_png

    H, W = hw
    for sub in ("rgb", "depth", "mask_visib"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
    gt, cam, gt_info, scene = {}, {}, {}, []
    for i in range(n_images):
        bgr = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        depth = np.zeros((H, W), np.float32)
        insts, renders = [], []
        for j in range(instances):
            z = rng.uniform(*z_range)
            u = W / 2 + (j - (instances - 1) / 2) * lateral * W + rng.uniform(-8, 8)
            v = H / 2 + rng.uniform(-0.1, 0.1) * H
            t = np.array([(u - K[0, 2]) * z / K[0, 0], (v - K[1, 2]) * z / K[1, 1], z])
            R, box = views[rows[i, j]], None
            for _ in range(8):
                col, d = renderer.render(0, W, H, K, R, t, 10, 10000)
                new = _mask_box(d > 0)
                if new == box:
                    break
                box, R = new, _view_rotation(new, K, views[rows[i, j]])
            else:
                raise AssertionError(f"image {i} instance {j}: the box of its rotation does not settle")
            insts.append((R, t, box))
            renders.append((col, d))
        for col, d in renders:
            vis = (d > 0) & ((depth == 0) | (d < depth))
            bgr[vis], depth[vis] = col[vis], d[vis]
        infos = []
        for j, (_, d) in enumerate(renders):
            vis = (d > 0) & (depth == d)
            write_png(os.path.join(scene_dir, "mask_visib", f"{i:06d}_{j:06d}.png"), vis.astype(np.uint8) * 255)
            infos.append({"bbox_obj": _mask_box(d > 0), "bbox_visib": _mask_box(vis),
                          "visib_fract": float(vis.sum() / (d > 0).sum())})
        write_png(os.path.join(scene_dir, "rgb", f"{i:06d}.png"), bgr)
        write_png(os.path.join(scene_dir, "depth", f"{i:06d}.png"), np.round(depth).astype(np.uint16))
        gt[str(i)] = [{"obj_id": 1, "cam_R_m2c": R.ravel().tolist(), "cam_t_m2c": t.tolist()} for R, t, _ in insts]
        cam[str(i)] = {"cam_K": K.ravel().tolist(), "depth_scale": 1.0}
        gt_info[str(i)] = infos
        scene.append(insts)
    for name, data in (("scene_gt", gt), ("scene_camera", cam), ("scene_gt_info", gt_info)):
        with open(os.path.join(scene_dir, f"{name}.json"), "w") as fh:
            json.dump(data, fh)
    return scene


def _subscene(src, dst, n_images):
    """Scene `dst` holding the first `n_images` images of scene `src`."""
    import shutil

    for sub in ("rgb", "depth", "mask_visib"):
        os.makedirs(os.path.join(dst, sub))
        for name in sorted(os.listdir(os.path.join(src, sub))):
            if int(name[:6]) < n_images:
                shutil.copy(os.path.join(src, sub, name), os.path.join(dst, sub, name))
    for name in ("scene_gt", "scene_camera", "scene_gt_info"):
        with open(os.path.join(src, f"{name}.json")) as fh:
            data = json.load(fh)
        with open(os.path.join(dst, f"{name}.json"), "w") as fh:
            json.dump({k: v for k, v in data.items() if int(k) < n_images}, fh)


EVAL_CFG_TEXT = """[METHOD]
METHOD: aae
[DATA]
DATASET: synth
DATASET_PATH: {dataset_path}
OBJ_ID: 1
SCENES: [{scene}]
CAM_TYPE:
[BBOXES]
ESTIMATE_BBS: False
SINGLE_INSTANCE: False
ICP: {icp}
ICP_FRAME_ACCURATE: {icp}
[EVALUATION]
COMPUTE_ERRORS: True
EVALUATE_ERRORS: True
[METRIC]
ERROR_TYPES: ['vsd', 're', 'te', 'add', 'adi', 'proj']
VSD_DELTA: 15
VSD_TAU: 20
VSD_COST: step
ERROR_THRESH: 0.3
ERROR_THRESH_DEG: 5
ERROR_THRESH_MM: 50
TOP_N_EVAL: 0
[PLOT]
COMPUTE_PLOTS: {plots}
"""
EVAL_RE_TOL_DEG = 1e-3  # every estimate's rotation error in the RGB run: the planted rows' poses
# the CPU port against the card, the same images: poses within phase 5's
# bounds; errors of equal poses equal (adi: B4's plain version against
# B4, operation for operation), of ICP poses within what those bounds
# carry over to (re in degrees, te / add / adi / proj in mm or px, vsd)
EVAL_ICP_ERR_TOL = {"vsd": 0.02, "re": 0.1, "te": 0.1, "add": 0.1, "adi": 0.1, "proj": 0.1}


def eval_phase(root, device, template_text, n_images=24, instances=3, image_hw=(540, 720), radius=40.0,
               z_range=(700.0, 800.0), lateral=0.3, delta=(20.0, 30.0), cpu_images=3, cpu_icp_images=1,
               seed=8):
    """The evaluation through its entry point, cli.ae_eval.main, at the
    template's width (128x128x3, filters [128, 256, 512, 512], latent 128,
    the 92,232-row codebook) on one BOP scene of `n_images` images of
    `instances` copies of a procedural 5,120-face mesh (radius `radius`)
    at z_range. The seeded full-width encoder's f32 code of each GT crop
    is planted in its GT view's codebook row (rows >= 40 deg apart, every
    other row orthogonal to the planted codes) with a rendered box whose
    projective depth lies `delta` mm short of the GT along the viewing
    ray. Two runs: (a) the RGB path (B3; errors vsd, re, te, add, adi on
    B4, proj); (b) ICP with ICP_FRAME_ACCURATE (B3, then B4 in the loop).
    Checks: (a) every estimate's row is its planted row and its re <=
    EVAL_RE_TOL_DEG; (b) ICP lowers te for >= 1 - MAX_WORSE_SHARE of the
    estimates, the others listed; the same evaluation on the CPU for the
    first `cpu_images` images (`cpu_icp_images` for (b)): the same rows,
    poses within POSE_T_TOL_MM / POSE_R_TOL, errors equal in (a) and within
    EVAL_ICP_ERR_TOL in (b). Returns a summary dict; raises on any failed
    check."""
    import numpy as np
    import torch

    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch import workspace as ws
    from augmentedautoencoder_torch.cli import ae_eval
    from augmentedautoencoder_torch.codebook import Codebook
    from augmentedautoencoder_torch.data.dataset import extract_square_patch
    from augmentedautoencoder_torch.evaluation.plots import have_matplotlib
    from augmentedautoencoder_torch.models import AAE
    from augmentedautoencoder_torch.ops import icp_nn
    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.renderer import Renderer, load_mesh
    from augmentedautoencoder_torch.renderer.procedural import make_textured_asymmetric, save_ply
    from augmentedautoencoder_torch.training.checkpoint import CheckpointManager
    from augmentedautoencoder_torch.utils.png import read_png

    t_setup = time.perf_counter()
    ws_path = os.path.join(root, "workspace")
    os.environ["AE_WORKSPACE_PATH"] = ws_path
    ws.init_workspace(ws_path)
    ply = os.path.join(root, "eval_obj.ply")
    save_ply(make_textured_asymmetric(subdivisions=4, radius=radius), ply)
    with open(ws.get_config_file_path(ws_path, "eval"), "w") as fh:
        fh.write("\n".join(f"MODEL_PATH: {ply}" if line.startswith("MODEL_PATH") else line
                           for line in template_text.splitlines()) + "\n")
    cfg, paths = factory.load_experiment_config("eval")
    K = cfg.K
    views = factory.embedding_viewsphere(cfg)
    n_rows, n_est = len(views), n_images * instances
    rng = np.random.RandomState(seed)
    chosen = []  # planted rows, rotations >= 40 deg apart
    for r in rng.permutation(n_rows):
        if not chosen or _angles(views[[r]], views[chosen]).min() >= 40.0:
            chosen.append(int(r))
            if len(chosen) == n_est:
                break
    if len(chosen) < n_est:
        raise AssertionError(f"only {len(chosen)} rotations 40 deg apart")
    rows = np.array(chosen).reshape(n_images, instances)
    data_root = os.path.join(root, "data")
    scene_dir = os.path.join(data_root, "test", "000001")
    renderer = Renderer([], backend="native", meshes=[load_mesh(ply)])
    scene = write_eval_scene(scene_dir, renderer, K, image_hw, views, rows, rng, instances, z_range, lateral,
                             n_images)
    _subscene(scene_dir, os.path.join(data_root, "test", "000002"), cpu_images)
    _subscene(scene_dir, os.path.join(data_root, "test", "000003"), cpu_icp_images)

    # the seeded full-width model (decoder too, for the reconstruction
    # figure) and its codebook with the GT crops' codes planted
    torch.manual_seed(seed)
    model = AAE.from_config(cfg, precision="float32", train=True).to(device).eval()
    crops, boxes = [], []
    for i in range(n_images):
        img = read_png(os.path.join(scene_dir, "rgb", f"{i:06d}.png"))
        for _, _, box in scene[i]:
            crops.append(extract_square_patch(img, box, cfg.pad_factor, resize=(cfg.w, cfg.h)))
            boxes.append(box)
    with torch.no_grad():
        x = torch.from_numpy(np.stack(crops)).to(device).to(torch.float32) / 255.0
        codes = model.encode(x).double().cpu().numpy()
    codes /= np.linalg.norm(codes, axis=1, keepdims=True)
    cos = codes @ codes.T - 2 * np.eye(n_est)
    if cos.max() > 0.999:
        raise AssertionError(f"two planted codes have cosine {cos.max():.5f}")
    emb = rng.randn(n_rows, codes.shape[1])
    basis, _ = np.linalg.qr(codes.T)
    emb -= (emb @ basis) @ basis.T
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[rows.ravel()] = codes
    wh = rng.randint(80, 160, (n_rows, 2))
    xy = np.array([K[0, 2], K[1, 2]]) - wh / 2 + rng.randint(-4, 5, (n_rows, 2))
    bbs = np.concatenate([xy, wh], axis=1).astype(np.int32)
    short = rng.uniform(*delta, n_est)
    for k, (r, box) in enumerate(zip(rows.ravel(), boxes)):
        # a box centred on the principal point whose projective depth puts
        # the estimate `short` mm before the GT along its viewing ray
        z = scene[k // instances][k % instances][1][2]
        w, h = (2 * np.round(np.asarray(box[2:], np.float64) * (z - short[k]) / cfg.radius / 2)).astype(int)
        bbs[r] = [int(K[0, 2]) - w // 2, int(K[1, 2]) - h // 2, w, h]
    CheckpointManager(paths["checkpoint_dir"]).save(0, model.state_dict(), emb.astype(np.float32), bbs)
    del model
    plots = have_matplotlib()
    log(f"  scene: {n_images} images {image_hw[1]}x{image_hw[0]}, {instances} instances each at "
        f"{z_range[0]:.0f}-{z_range[1]:.0f} mm; {n_rows} codebook rows, {n_est} planted (max cosine between "
        f"them {cos.max():.4f}); matplotlib {'imports: COMPUTE_PLOTS True' if plots else 'missing: COMPUTE_PLOTS False'}"
        f"; set up in {time.perf_counter() - t_setup:.1f} s")

    for name, scene_id, icp in (("rgb", 1, False), ("icp", 1, True), ("rgb_cpu", 2, False),
                                ("icp_cpu", 3, True)):
        with open(ws.get_eval_config_file_path(ws_path, f"{name}.cfg"), "w") as fh:
            fh.write(EVAL_CFG_TEXT.format(dataset_path=data_root, scene=scene_id, icp=icp, plots=plots))

    rows_seen = []
    pose_batch = Codebook.auto_pose6d_batch

    def recording(self, *args, **kw):
        out = pose_batch(self, *args, **kw)
        if kw.get("depth_pred") is None:  # not ICP's stage 2
            rows_seen.append(np.asarray(out[2]))
        return out

    wrappers = (mc.grouped_codebook_top1, mc.grouped_codebook_topk, nq.cosine_top1_cuda, icp_nn.batched_nn_cuda)
    runs = {}
    Codebook.auto_pose6d_batch = recording
    try:
        # ---- the main path: counts from 0, read right after
        for fn in wrappers:
            fn.launches = 0
        for name in ("rgb", "icp"):
            rows_seen.clear()
            np.random.seed(seed)  # ICP's subsampling draws from the global stream
            t0 = time.perf_counter()
            out = ae_eval.main(["eval", name, "--eval_cfg", f"{name}.cfg"], device=device)
            runs[name] = dict(out, wall=time.perf_counter() - t0, rows=list(rows_seen))
        launches = {fn.__name__: fn.launches for fn in wrappers}
        for name, dev in (("rgb_cpu", "cpu"), ("icp_cpu", "cpu")):
            rows_seen.clear()
            np.random.seed(seed)
            torch.set_num_threads(os.cpu_count() or 1)
            t0 = time.perf_counter()
            out = ae_eval.main(["eval", name, "--eval_cfg", f"{name}.cfg"], device=dev)
            runs[name] = dict(out, wall=time.perf_counter() - t0, rows=list(rows_seen))
    finally:
        Codebook.auto_pose6d_batch = pose_batch
    log(f"  main-path launches: {launches}")
    if str(device).startswith("cuda") and min(launches[k] for k in ("cosine_top1_cuda", "batched_nn_cuda")) < 1:
        raise AssertionError(f"a kernel of the evaluation path was not launched by it: {launches}")

    # ---- (a) the RGB run: planted rows, GT rotations
    rgb, icp = runs["rgb"], runs["icp"]
    if len(rgb["results"]) != n_est or len(icp["results"]) != n_est:
        raise AssertionError(f"{len(rgb['results'])} / {len(icp['results'])} estimates for {n_est} GTs")
    got_rows = np.concatenate(rgb["rows"])
    want_rows = np.array([rows[r.im_id, r.gt_idx] for r in rgb["results"]])
    if not np.array_equal(got_rows, want_rows):
        bad = np.flatnonzero(got_rows != want_rows)
        raise AssertionError(f"estimates {bad.tolist()} returned rows {got_rows[bad].tolist()}, "
                             f"planted {want_rows[bad].tolist()}")
    re_a = np.array([r.errors["re"] for r in rgb["results"]])
    if not re_a.max() <= EVAL_RE_TOL_DEG:
        raise AssertionError(f"rotation error up to {re_a.max():.2e} deg > {EVAL_RE_TOL_DEG}")
    # ---- (b) ICP against the GT translations
    te_a = np.array([r.errors["te"] for r in rgb["results"]])
    te_b = np.array([r.errors["te"] for r in icp["results"]])
    worse = np.flatnonzero(te_b >= te_a)
    if worse.size:
        log(f"  ICP did not lower te of estimates {worse.tolist()}: "
            + ", ".join(f"{a:.2f} -> {b:.2f}" for a, b in zip(te_a[worse], te_b[worse])) + " mm")
    if worse.size > MAX_WORSE_SHARE * n_est:
        raise AssertionError(f"ICP did not lower te of {worse.size} of {n_est} estimates")

    # ---- the CPU port on the first images
    for name, ref in (("rgb_cpu", rgb), ("icp_cpu", icp)):
        cpu = runs[name]
        n = len(cpu["results"])
        if n != instances * (cpu_images if name == "rgb_cpu" else cpu_icp_images):
            raise AssertionError(f"{name}: {n} estimates")
        if not all(np.array_equal(a, b) for a, b in zip(cpu["rows"], ref["rows"])):
            raise AssertionError(f"{name}: rows {cpu['rows']} against {ref['rows'][:len(cpu['rows'])]}")
        dt = max(float(np.abs(c.t_est - g.t_est).max()) for c, g in zip(cpu["results"], ref["results"]))
        dr = max(float(np.abs(c.R_est - g.R_est).max()) for c, g in zip(cpu["results"], ref["results"]))
        if not (dt <= POSE_T_TOL_MM and dr <= POSE_R_TOL):
            raise AssertionError(f"{name}: card vs CPU poses differ by {dt} mm / {dr} in R")
        derr = {et: max(abs(c.errors[et] - g.errors[et]) for c, g in zip(cpu["results"], ref["results"]))
                for et in EVAL_ICP_ERR_TOL}
        tol = EVAL_ICP_ERR_TOL if name == "icp_cpu" else {et: 0.0 for et in EVAL_ICP_ERR_TOL}
        if name == "rgb_cpu" and (dt or dr):
            raise AssertionError(f"{name}: the same rows gave other poses ({dt} mm, {dr})")
        over = {et: d for et, d in derr.items() if not d <= tol[et]}
        if over:
            raise AssertionError(f"{name}: card vs CPU errors differ by {over}")
        log(f"  {name}: {n} estimates on the CPU: the card's rows, max |dt| {dt:.2e} mm, max |dR| {dr:.2e}, "
            "errors max |d| " + ", ".join(f"{et} {d:.2e}" for et, d in derr.items()))

    summary = {"estimates": n_est, "launches": launches, "plots": plots,
               # for phase 12's overlays: the scene, the card's estimates and the CPU port's
               "scene": {"data_root": data_root, "scene_dir": scene_dir, "ply": ply, "K": np.asarray(K),
                         "card": [(r.im_id, r.R_est, r.t_est) for r in rgb["results"]],
                         "cpu": [(r.im_id, r.R_est, r.t_est) for r in runs["rgb_cpu"]["results"]],
                         "cpu_images": cpu_images}}
    # ---- device busy share of both runs over the first images, under torch.profiler
    if str(device).startswith("cuda"):
        for name, icp_on in (("rgb", False), ("icp", True)):
            with open(ws.get_eval_config_file_path(ws_path, f"{name}_prof.cfg"), "w") as fh:
                fh.write(EVAL_CFG_TEXT.format(dataset_path=data_root, scene=2, icp=icp_on, plots=False))
            np.random.seed(seed)
            prof = device_profile(lambda: ae_eval.main(["eval", f"{name}_prof", "--eval_cfg", f"{name}_prof.cfg"],
                                                       device=device), n_frames=cpu_images)
            summary[f"{name}_profile"] = prof
            if prof is None:
                log(f"  {name}: torch.profiler saw no device time (busy share not measured)")
                continue
            top = ", ".join(f"{k} {v:.3f}" for k, v in prof["top_ms_per_frame"])
            log(f"  {name}, first {cpu_images} images under the profiler: device busy {prof['device_ms']:.1f} of "
                f"{prof['wall_ms']:.1f} ms ({100 * prof['device_ms'] / prof['wall_ms']:.1f}% busy); top (ms/image): "
                f"{top}")
    for name in ("rgb", "icp"):
        sec = runs[name]["seconds"]
        run_s = sum(v for k, v in sec.items() if k not in ("setup", "figures"))
        summary[name] = {"wall_s": runs[name]["wall"], "run_s": run_s, "estimates_per_s": n_est / run_s,
                         "seconds": dict(sec), "recall": {et: s["recall"] for et, s in runs[name]["scores"].items()}}
        log(f"  {name}: {n_est} estimates in {runs[name]['wall']:.2f} s (ae_eval.main), evaluation "
            f"{run_s:.2f} s = {n_est / run_s:.2f} estimates/s; split (s): "
            + ", ".join(f"{k} {v:.3f}" for k, v in sec.items()))
        log(f"  {name} recall: " + ", ".join(f"{et} {s['recall']:.4f} ({s['n_correct']}/{s['n_gt']})"
                                             for et, s in runs[name]["scores"].items()))
    summary["re_max_deg"] = float(re_a.max())
    summary["te_before_mm"], summary["te_after_mm"] = float(np.median(te_a)), float(np.median(te_b))
    summary["worse"] = int(worse.size)
    log(f"  rgb: planted rows retrieved for all {n_est}, re max {re_a.max():.2e} deg; te median "
        f"{np.median(te_a):.3f} mm -> after ICP {np.median(te_b):.3f} mm (max {te_b.max():.3f}), lower for "
        f"{n_est - worse.size} of {n_est}")
    return summary


# ------------------------------------------------------------------ phase 9
DSPRITES_LATENT_SIZES = (1, 3, 6, 40, 32, 32)  # color, shape, scale, orientation, posX, posY


def write_dsprites_npz(path, hw=64, seed=9):
    """A dsprites-format .npz with the real latent grid (737,280 images of
    `hw` x `hw`, {0, 1} uint8, latents_classes, metadata's latents_sizes):
    three seeded star-shaped outlines, radius r(phi) = s (1 + sum_k a_k
    cos(k (phi - theta) + b_k)), k = 1..3, at 6 scales, 40 orientations
    theta and 32 x 32 positions (posX a column shift, posY a row shift)."""
    import numpy as np
    from numpy.lib.stride_tricks import sliding_window_view

    sizes = np.array(DSPRITES_LATENT_SIZES)
    rng = np.random.RandomState(seed)
    amp, phase = rng.uniform(0.05, 0.25, (3, 3)), rng.uniform(0.0, 2 * np.pi, (3, 3))
    canvas = 3 * hw // 2
    c0 = canvas / 2
    yy, xx = np.mgrid[:canvas, :canvas] + 0.5 - c0
    rho, phi = np.hypot(xx, yy), np.arctan2(yy, xx)
    # window offset of each position: the sprite's centre moves over [hw / 4, 3 hw / 4]
    offs = np.round(c0 - (hw / 4 + np.arange(32) * (hw / 2) / 31)).astype(np.int64)
    imgs = np.empty(tuple(sizes) + (hw, hw), np.uint8)
    k = np.arange(1, 4)[:, None, None]
    for shape in range(3):
        for scale in range(6):
            for o in range(40):
                theta = 2 * np.pi * o / 40
                r = (0.5 + 0.1 * scale) * 0.18 * hw * (
                    1 + (amp[shape][:, None, None] * np.cos(k * (phi - theta) + phase[shape][:, None, None])).sum(0))
                win = sliding_window_view((rho <= r).astype(np.uint8), (hw, hw))
                imgs[0, shape, scale, o] = win[np.ix_(offs, offs)].transpose(1, 0, 2, 3)
    grids = np.meshgrid(*[np.arange(n) for n in sizes], indexing="ij")
    latents = np.stack([g.reshape(-1) for g in grids], axis=1)
    np.savez(path, imgs=imgs.reshape((-1, hw, hw)), latents_classes=latents,
             latents_values=latents.astype(np.float32), metadata=np.array({"latents_sizes": sizes}))
    return path


def dsprites_phase(root, device, template_text, hw=64, num_iter=100, save_interval=50, seed=9):
    """MODEL dsprites through its entry points, cli.ae_train.main and
    cli.ae_embed.main, at the template's width with `hw` x `hw` x 1 inputs
    (the template's augmentation) on a synthetic dsprites-format .npz of the
    real latent grid (`write_dsprites_npz`), then the orientation codebook
    queried against itself (nn_query.cosine_top1, B3). Checks the logged
    losses finite and falling (mean of the last 5 below the first 5);
    chkpt-<save_interval> and chkpt-<num_iter> written; the (40, latent)
    unit-row codebook written into chkpt-<num_iter> and restored by
    restore_experiment; the codebook's images encoded on `device` against
    the port on the CPU from the same checkpoint (max |dz| <=
    EMBED_CPU_TOL, raw and normalized); the stored codebook against the CPU
    codes (<= EMBED_CPU_TOL); each row its own top-1. Returns a summary."""
    import numpy as np
    import torch

    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch import workspace as ws
    from augmentedautoencoder_torch.cli import ae_embed, ae_train
    from augmentedautoencoder_torch.data.dsprites import codebook_images, load_dsprites_training_images
    from augmentedautoencoder_torch.ops import icp_nn
    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.training import CheckpointManager

    ws_path = os.path.join(root, "workspace")
    os.environ["AE_WORKSPACE_PATH"] = ws_path
    ws.init_workspace(ws_path)
    t0 = time.perf_counter()
    npz = write_dsprites_npz(os.path.join(root, "dsprites.npz"), hw=hw, seed=seed)
    make_s = time.perf_counter() - t0
    subs = {"MODEL": "dsprites", "MODEL_PATH": npz, "H": hw, "W": hw, "C": 1, "NUM_ITER": num_iter,
            "SAVE_INTERVAL": save_interval, "EMBED_BB": False}
    lines = []
    for line in template_text.splitlines():
        key = line.split(":")[0].strip()
        lines.append(f"{key}: {subs[key]}" if key in subs else line)
    with open(ws.get_config_file_path(ws_path, "sprites"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    log(f"  synthetic dsprites .npz: {int(np.prod(DSPRITES_LATENT_SIZES))} images of {hw}x{hw} on the real "
        f"latent grid {DSPRITES_LATENT_SIZES}, written in {make_s:.1f} s ({os.path.getsize(npz) / 2**30:.2f} GiB)")

    # ---- the main path: counts from 0, read right after
    wrappers = (mc.grouped_codebook_top1, mc.grouped_codebook_topk, nq.cosine_top1_cuda, icp_nn.batched_nn_cuda)
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = ae_train.main(["sprites", "--seed", str(seed)], device=device)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ae_embed.main(["sprites"], device=device)
    embed_s = time.perf_counter() - t0
    cfg, _, model, payload = factory.restore_experiment("sprites", device=device)
    codebook = payload["embedding_normalized"].to(device)
    vals, idx = nq.cosine_top1(codebook, codebook)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"  main-path launches: {launches}")
    ends = np.asarray(trainer.step_end_times)
    step_ms = float(np.median(np.diff(ends[min(20, len(ends) // 2):]))) * 1e3
    log(f"  ae_train: {trainer.step} steps in {train_s:.1f} s ({cfg.h}x{cfg.w}x{cfg.c}, filters {cfg.num_filter}, "
        f"latent {cfg.latent_space_size}, batch {cfg.batch_size}; load, steps, 2 saves), {step_ms:.3f} ms/step; "
        f"ae_embed (dsprites codebook) in {embed_s:.1f} s")

    paths = factory.experiment_paths("sprites")
    with open(os.path.join(paths["checkpoint_dir"], "metrics.jsonl")) as fh:
        total = np.array([json.loads(line)["total_loss"] for line in fh])
    if not (len(total) >= 10 and np.isfinite(total).all()):
        raise AssertionError(f"dsprites logged losses: {total.tolist()}")
    first, last = float(total[:5].mean()), float(total[-5:].mean())
    if not last < first:
        raise AssertionError(f"the dsprites loss did not fall: first 5 {total[:5].tolist()}, last 5 {total[-5:].tolist()}")
    steps = CheckpointManager(paths["checkpoint_dir"]).all_steps()
    if not {save_interval, num_iter} <= set(steps) or payload["step"] != num_iter:
        raise AssertionError(f"dsprites checkpoints {steps}, restored step {payload['step']}")
    norms = codebook.norm(dim=1)
    if tuple(codebook.shape) != (40, cfg.latent_space_size) or not bool(((norms - 1).abs() <= 1e-5).all()):
        raise AssertionError(f"dsprites codebook {tuple(codebook.shape)}, row norms {norms.tolist()}")
    if payload.get("embed_obj_bbs") is not None:
        raise AssertionError("the dsprites codebook was saved with boxes")

    # ---- the codebook's images on the device and on the CPU from the same checkpoint
    _, train_y = load_dsprites_training_images(npz)
    x = torch.from_numpy(codebook_images(train_y))
    _, _, cpu_model, _ = factory.restore_experiment("sprites", device="cpu")
    with torch.no_grad():
        z_dev = model.encode(x.to(device)).cpu()
        z_cpu = cpu_model.encode(x)
    n_dev, n_cpu = (z / z.norm(dim=1, keepdim=True) for z in (z_dev, z_cpu))
    dz, dn = float((z_dev - z_cpu).abs().max()), float((n_dev - n_cpu).abs().max())
    dstored = float((codebook.cpu() - n_cpu).abs().max())
    # each unit row is its own best match (Cauchy-Schwarz) up to rounding; the
    # kernel's answer against its plain version on the same rows
    plain_vals, plain_idx = nq.cosine_top1_plain(codebook, codebook)
    own_cos = (codebook * codebook).sum(dim=1)
    own = int((idx.cpu() == torch.arange(40)).sum())
    self_best = bool(((vals - own_cos).abs() <= MARGIN).all())
    same = bool(torch.equal(idx.cpu(), plain_idx.cpu())) and float((vals - plain_vals).abs().max()) <= VAL_TOL
    log(f"  losses: {len(total)} logged, all finite; mean of the first 5 {first:.6f}, of the last 5 {last:.6f}; "
        f"chkpt-{save_interval} and chkpt-{num_iter}; codebook (40, {cfg.latent_space_size}) unit rows, no boxes, "
        f"restored by restore_experiment; its 40 images, {device} vs CPU: max |dz| {dz:.2e}, normalized {dn:.2e}, "
        f"stored vs CPU {dstored:.2e} (tol {EMBED_CPU_TOL}); self-retrieval (B3): {own} of 40 own rows, every best "
        f"cosine within {MARGIN} of the row's own: {self_best}, equal to the plain version: {same}")
    if not (dz <= EMBED_CPU_TOL and dn <= EMBED_CPU_TOL and dstored <= EMBED_CPU_TOL and self_best and same):
        raise AssertionError(f"dsprites codebook {device} vs CPU: dz {dz}, normalized {dn}, stored {dstored}; "
                             f"self-retrieval {idx.tolist()} {vals.tolist()}, plain {plain_idx.tolist()}")
    if str(device).startswith("cuda") and not launches["cosine_top1_cuda"]:
        raise AssertionError(f"B3 was not launched by the dsprites path: {launches}")
    return {"launches": launches, "step_ms": step_ms, "train_s": train_s, "embed_s": embed_s,
            "loss_first5": first, "loss_last5": last, "dz": dz}


# ------------------------------------------------------------------ phase 10
JPEG_FIXTURE = os.path.join("tests", "fixtures", "torch_port", "background_q95_420.jpg")
TF_FIXTURE = os.path.join("tests", "fixtures", "torch_port", "tf_ckpt")
# the imported model's codes against TensorFlow's (f32, TF32 off; the
# convolutions summed in other orders), and the card's poses against the
# CPU port's (phase 4's bound)
IMPORT_CODE_TOL = 1e-5
IMPORT_POSE_TOL = 1e-4


def jpeg_phase():
    """The port's background decode (data.dataset.decode_bgr, PIL) of the
    committed baseline 4:2:0 JPEG against the committed cv2.imread decode,
    byte for byte, on this machine's Pillow and libjpeg."""
    import numpy as np
    import PIL
    from PIL import features

    from augmentedautoencoder_torch.data.dataset import decode_bgr

    path = os.path.join(REPO, JPEG_FIXTURE)
    want = np.load(path[:-len(".jpg")] + "_cv2.npy")
    got = decode_bgr(path)
    same = got.shape == want.shape and got.dtype == want.dtype and bool((got == want).all())
    n_diff = int((got != want).sum()) if got.shape == want.shape else got.size
    log(f"  {JPEG_FIXTURE} ({want.shape[1]}x{want.shape[0]}) through decode_bgr on Pillow {PIL.__version__} "
        f"(libjpeg {features.version('jpg')}): {'equal to' if same else f'{n_diff} bytes differ from'} the stored "
        f"cv2.imread decode")
    if not same:
        raise AssertionError(f"the PIL decode of {JPEG_FIXTURE} differs from cv2's in {n_diff} bytes")
    return {"pillow": PIL.__version__, "libjpeg": features.version("jpg")}


# ------------------------------------------------------------------ main
# ------------------------------------------------------------------ phase 11
def import_phase(root, device, frames_of=16):
    """ae_import_tf on the card's machine: the committed TF1 checkpoint
    fixture (tests/fixtures/torch_port/tf_ckpt: the reference graph at
    32x32x3, filters [8, 16], latent 8, a 50-row codebook of TensorFlow's
    unit codes of 50 seeded images) imported through cli.ae_import_tf.main
    with `tensorflow` blocked from import. Checks the codes of the 4 test
    inputs on `device` against TensorFlow's (IMPORT_CODE_TOL); the 50
    codebook images retrieving their own rows through Codebook.
    nearest_rotation (B3); and frames of them (`frames_of` 32x32 boxes a
    128x128 frame, PAD_FACTOR 1: each crop is its image) served by
    AePoseEstimator (B3) and by PoseServer f32 top-1 (B1), each equal to
    the CPU port's plain versions (IMPORT_POSE_TOL). Returns a summary
    dict with the path's launches and the import's seconds."""
    import importlib.util

    import numpy as np
    import torch

    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch import workspace as ws
    from augmentedautoencoder_torch.cli import ae_import_tf
    from augmentedautoencoder_torch.codebook import f32_without_tf32
    from augmentedautoencoder_torch.ops import icp_nn
    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.pose import AePoseEstimator, BoundingBox
    from augmentedautoencoder_torch.serving import PoseServer

    fixture = os.path.join(REPO, TF_FIXTURE)
    spec = importlib.util.spec_from_file_location("make_tf_fixture", os.path.join(os.path.dirname(fixture),
                                                                                  "make_tf_fixture.py"))
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    has_tf = importlib.util.find_spec("tensorflow") is not None
    log(f"  tensorflow importable on this machine: {'yes' if has_tf else 'no'}; blocked for this phase")
    ws_path = os.path.join(root, "workspace")
    os.environ["AE_WORKSPACE_PATH"] = ws_path
    ws.init_workspace(ws_path)
    imgs = fx.images(fx.N_TEST + fx.N_ROWS)
    test_cfg = os.path.join(root, "test.cfg")
    with open(test_cfg, "w") as fh:
        fh.write("[auto_pose]\ncamPose = False\nupright = False\ntopk = 1\ncolor_format = bgr\n"
                 "color_data_type = np.float32\ndepth_data_type = np.float32\n"
                 "class_2_encoder = {'tf_cls': 'tf_imported'}\n")
    frames = []
    for start in range(0, fx.N_ROWS, frames_of):
        rows = list(range(start, min(start + frames_of, fx.N_ROWS)))
        img, boxes = np.zeros((128, 128, 3), np.uint8), []
        for k, r in enumerate(rows):
            x0, y0 = 32 * (k % 4), 32 * (k // 4)
            img[y0:y0 + 32, x0:x0 + 32] = imgs[fx.N_TEST + r]
            boxes.append(BoundingBox(x0 / 128, y0 / 128, (x0 + 32) / 128, (y0 + 32) / 128, {"tf_cls": 1.0}))
        frames.append({"bboxes": boxes, "color_img": img,
                       "camK": np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]])})

    # ---- the main path: counts from 0, read right after
    wrappers = (mc.grouped_codebook_top1, mc.grouped_codebook_topk, nq.cosine_top1_cuda, icp_nn.batched_nn_cuda)
    for fn in wrappers:
        fn.launches = 0
    blocked, sys.modules["tensorflow"] = sys.modules.get("tensorflow"), None
    try:
        t0 = time.perf_counter()
        ae_import_tf.main([os.path.join(fixture, f"chkpt-{fx.STEP}"), "tf_imported", "--cfg",
                           os.path.join(fixture, "train.cfg"), "--scope", fx.SCOPE])
        import_s = time.perf_counter() - t0
    finally:
        if blocked is None:
            del sys.modules["tensorflow"]
        else:
            sys.modules["tensorflow"] = blocked
    codebook = factory.build_codebook_from_name("tf_imported", device=device)
    with f32_without_tf32():
        z = codebook.test_embedding(imgs[:fx.N_TEST], normalized=False)
        rows = np.asarray(codebook.nearest_rotation(imgs[fx.N_TEST:], return_idcs=True)).ravel()
        est = AePoseEstimator(test_cfg, device=device)
        server = PoseServer(test_cfg, max_dets_per_class=frames_of, precision="float32", device=device)
        served = {"estimator": [est.process(**f) for f in frames], "server": [server.process(**f) for f in frames]}
    launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"  main-path launches: {launches}")
    code_err = float(np.abs(z - np.load(os.path.join(fixture, "codes.npy"))).max())
    self_rows = int((rows == np.arange(fx.N_ROWS)).sum())

    # the same on the CPU: the plain versions
    cpu_rows = np.asarray(factory.build_codebook_from_name("tf_imported", device="cpu").nearest_rotation(
        imgs[fx.N_TEST:], return_idcs=True)).ravel()
    cpu = [AePoseEstimator(test_cfg, device="cpu").process(**f) for f in frames]
    pose_errs = {}
    for name, got in served.items():
        pose_errs[name] = max(float(np.abs(g.trafo - w.trafo).max()) for fg, fw in zip(got, cpu) for g, w in zip(fg, fw))
        if [len(f) for f in got] != [len(f) for f in cpu]:
            raise AssertionError(f"import: {name} served {[len(f) for f in got]} poses, the CPU {[len(f) for f in cpu]}")
    n_det = sum(len(f["bboxes"]) for f in frames)
    log(f"  imported the {fx.N_ROWS}-row fixture (32x32x3, filters {fx.FILTERS}, latent {fx.LATENT}) in "
        f"{import_s:.2f} s; codes of the {fx.N_TEST} test inputs on {device} against TensorFlow's: max |dz| "
        f"{code_err:.2e}; {self_rows} of {fx.N_ROWS} rows retrieve themselves through B3 (the CPU's plain "
        f"version: {int((cpu_rows == np.arange(fx.N_ROWS)).sum())}); {n_det} detections in {len(frames)} frames, "
        f"max |dtrafo| against the CPU port: estimator (B3) {pose_errs['estimator']:.2e}, PoseServer f32 top-1 "
        f"(B1) {pose_errs['server']:.2e}")
    if not code_err <= IMPORT_CODE_TOL or self_rows != fx.N_ROWS or not np.array_equal(rows, cpu_rows):
        raise AssertionError(f"import: codes {code_err}, rows {rows.tolist()}, CPU rows {cpu_rows.tolist()}")
    if not max(pose_errs.values()) <= IMPORT_POSE_TOL:
        raise AssertionError(f"import: served poses against the CPU port {pose_errs}")
    if str(device).startswith("cuda") and not (launches["cosine_top1_cuda"] and launches["grouped_codebook_top1"]):
        raise AssertionError(f"import: B3 and B1 not both launched: {launches}")
    return {"launches": launches, "import_s": import_s, "code_err": code_err, "pose_errs": pose_errs}


# ------------------------------------------------------------------ phase 12
DEMO_POSE_TOL = 1e-4  # phase 4's trafo bound: the demos' poses, card vs CPU port
DEMO_LABEL_MAP = "item {\n  id: 1\n  name: 'obj'\n  display_name: 'obj'\n}\n"


class DemoCamera:
    """The demos' capture seam: serves `frames` in turn, one a read, a read
    every `period_s` (a camera's pace for the grabber thread)."""

    def __init__(self, frames, period_s=0.005):
        self.frames, self.reads, self.period_s = frames, 0, period_s
        self.released, self.props = False, {}

    def __call__(self, src):
        return self

    def set(self, prop, value):
        self.props[prop] = value

    def read(self):
        time.sleep(self.period_s)
        frame = self.frames[self.reads % len(self.frames)]
        self.reads += 1
        return True, frame.copy()

    def release(self):
        self.released = True


class DemoWindow:
    """The demos' display seam: keeps what is shown; 'q' at the
    `quit_after`-th key poll."""

    def __init__(self, quit_after):
        self.shown, self.polls, self.quit_after = [], 0, quit_after

    def imshow(self, name, img):
        import numpy as np

        self.shown.append((name, np.array(img)))

    def wait_key(self, ms):
        self.polls += 1
        return ord("q") if self.polls >= self.quit_after else 255


def _frame_index(frames, frame):
    import numpy as np

    return next(i for i, f in enumerate(frames) if np.array_equal(f, frame))


def detector_split(frames, reps=5, **detector_kwargs):
    """`ForegroundContourDetector.process` on `frames` with nothing else
    running, in host ms: the median over frames of each frame's median of
    `reps` runs of each step -- the foreground mask, the 3x3 opening,
    scipy's labelling, OpenCV's order (labelling and order less the
    labelling), the stats (`connected_components_stats` less labelling and
    order), the boxes (the whole less the rest), and the whole."""
    import numpy as np
    from scipy import ndimage

    from augmentedautoencoder_torch.pose.detectors import ForegroundContourDetector
    from augmentedautoencoder_torch.utils import draw

    det = ForegroundContourDetector(**detector_kwargs)

    def ms(fn, *args):
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            runs.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(runs))

    rows = []
    for frame in frames:
        mask = det._foreground_mask(frame).astype(np.uint8)
        opened = draw.morph_open3x3(mask)
        r = {"mask": ms(lambda: det._foreground_mask(frame).astype(np.uint8)),
             "opening": ms(draw.morph_open3x3, mask),
             "label": ms(lambda: ndimage.label(opened != 0, structure=np.ones((3, 3), bool))),
             "label_order": ms(draw._components_in_cv2_order, opened),
             "label_order_stats": ms(draw.connected_components_stats, opened),
             "whole": ms(det.process, frame)}
        rows.append({"mask": r["mask"], "opening": r["opening"], "label": r["label"],
                     "order": r["label_order"] - r["label"], "stats": r["label_order_stats"] - r["label_order"],
                     "boxes": r["whole"] - r["mask"] - r["opening"] - r["label_order_stats"], "whole": r["whole"]})
    return {k: float(np.median([r[k] for r in rows])) for k in rows[0]}


def demo_phase(root, device, template_text, embed_ws=None, eval_scene=None, n_crops=16, n_frames=8,
               cpu_crops=4, n_scenes=4, seed=12):
    """The demos and the detector-data generators on the card's machine (no
    OpenCV), through their entry points, on phase 6's embedded experiment
    (`embed_ws`; embedded again at the template's width if it is gone):
      * cli.aae_image on `n_crops` PNG crops of re-rendered codebook views:
        each (128, 256) estimate's row is its own or a duplicate within
        MARGIN of its cosine (phase 6's rule), its estimate pane the render
        of that rotation; the first `cpu_crops` again on the CPU: the same
        rows;
      * cli.aae_webcam through the capture and display seams, a camera of
        720x540 renders and 'q' after `n_frames` frames: two panes a frame,
        the camera released, each crop's row the CPU port's;
      * cli.detector_webcam_pose with ForegroundContourDetector and a .pbtxt
        label map on 720x540 frames of 1-3 rendered objects on black: the
        boxes the detector's on the host, the poses within DEMO_POSE_TOL of
        the CPU port's AePoseEstimator (a pose apart only where its crop's
        two rows tie within MARGIN, listed), the overlay the CPU's outside
        the text boxes; host ms a frame split into detect / estimate / draw,
        then `detector_split` on the same frames;
      * PoseVisualizer.render_poses and plot_scene_with_3d_boxes on phase
        8's scene (`eval_scene`) with the card's estimates, equal to the same
        with the CPU port's estimates of those images;
      * cli.generate_syn_det_train and cli.generate_sixd_train (phase 8's
        BOP scene), `n_scenes` each at the camera's size: PNG and VOC XML
        written, every box inside the frame, seconds a scene.
    B3's launches are counted over all of it. Returns a summary dict;
    raises on any failed check."""
    import json as _json

    import numpy as np
    import torch

    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch.cli import (aae_image, aae_webcam, ae_embed, detector_webcam_pose,
                                                generate_sixd_train, generate_syn_det_train)
    from augmentedautoencoder_torch.codebook import f32_without_tf32
    from augmentedautoencoder_torch.evaluation.plots import plot_scene_with_3d_boxes
    from augmentedautoencoder_torch.ops import icp_nn
    from augmentedautoencoder_torch.ops import multi_codebook as mc
    from augmentedautoencoder_torch.ops import nn_query as nq
    from augmentedautoencoder_torch.pose import AePoseEstimator, BoundingBox, PoseEstimate
    from augmentedautoencoder_torch.pose.detectors import ForegroundContourDetector
    from augmentedautoencoder_torch.pose.estimator import extract_square_patch_centered
    from augmentedautoencoder_torch.pose.label_map import remap_box_classes
    from augmentedautoencoder_torch.renderer import Renderer, load_mesh
    from augmentedautoencoder_torch.renderer.write_xml import parse_voc_xml
    from augmentedautoencoder_torch.utils import draw
    from augmentedautoencoder_torch.utils.png import read_png, write_png
    from augmentedautoencoder_torch.visualization import PoseVisualizer

    t_setup = time.perf_counter()
    if embed_ws is None or not os.path.isdir(embed_ws):
        log("  phase 6's workspace is gone: embedding the experiment again")
        embed_ws, _, _ = embed_experiment(os.path.join(root, "embed"), template_text)
        ae_embed.main(["embed"], device=device)
    os.environ["AE_WORKSPACE_PATH"] = embed_ws
    cfg, paths = factory.load_experiment_config("embed")
    W, H = cfg.render_dims
    K = np.asarray(cfg.K, np.float64)
    dataset = factory.build_dataset(paths["dataset_path"], cfg)
    renderer = dataset.renderer
    card_cb = factory.build_codebook_from_name("embed", device=device)
    cpu_cb = factory.build_codebook_from_name("embed", device="cpu")
    views = card_cb.viewsphere
    emb = card_cb.embedding_normalized.float().cpu().numpy()
    n_rows = len(views)
    rng = np.random.RandomState(seed)

    # aae_image's folder: crops of re-rendered codebook views
    rows = np.sort(rng.choice(n_rows, n_crops, replace=False))
    crop_dir, cpu_dir = os.path.join(root, "crops"), os.path.join(root, "crops_cpu")
    os.makedirs(crop_dir)
    os.makedirs(cpu_dir)
    crops = np.concatenate([dataset.render_embedding_image_batch(int(r), int(r) + 1)[0] for r in rows])
    crops = np.ascontiguousarray(crops.astype(np.uint8))
    for k, (r, crop) in enumerate(zip(rows, crops)):
        write_png(os.path.join(crop_dir, f"view_{r:06d}.png"), crop)
        if k < cpu_crops:
            write_png(os.path.join(cpu_dir, f"view_{r:06d}.png"), crop)

    # the camera's frames: one view each at the render distance
    def render(Rs, ts):
        bgr, _, _ = renderer.render_many([0] * len(Rs), W, H, K, Rs, ts, cfg.clip_near, cfg.clip_far,
                                         random_light=False)
        return bgr

    cam_rows = rng.choice(n_rows, n_frames, replace=False)
    cam_frames = [render([views[r]], [np.array([0.0, 0.0, cfg.radius])]) for r in cam_rows]
    # the detector's frames: 1-3 objects side by side on black
    det_frames, det_counts = [], []
    for i in range(n_frames):
        k = 1 + i % 3
        slots = rng.permutation(3)[:k]
        Rs, ts = [], []
        for slot in slots:
            z = cfg.radius * rng.uniform(0.95, 1.05)
            px = (slot - 1) * W / 3.0 + rng.uniform(-0.02, 0.02) * W
            py = rng.uniform(-0.05, 0.05) * H
            ts.append(np.array([px * z / K[0, 0], py * z / K[1, 1], z]))
            Rs.append(views[rng.randint(n_rows)])
        det_frames.append(render(Rs, ts))
        det_counts.append(k)
    label_map = os.path.join(root, "labels.pbtxt")
    with open(label_map, "w") as fh:
        fh.write(DEMO_LABEL_MAP)
    test_cfg = os.path.join(root, "demo_test.cfg")
    with open(test_cfg, "w") as fh:
        fh.write("[auto_pose]\ncamPose = False\nupright = False\ntopk = 1\ncolor_format = bgr\n"
                 "color_data_type = np.float32\ndepth_data_type = np.float32\n"
                 "class_2_encoder = {'obj': 'embed'}\n")
    detector_spec = ("augmentedautoencoder_torch.pose.detectors:ForegroundContourDetector:"
                     + _json.dumps({"class_name": "1", "thresh": 5}))
    det_argv = [test_cfg, "--detector", detector_spec, "--label_map", label_map,
                "--camK", ",".join(repr(float(v)) for v in K.ravel())]
    bg_dir = os.path.join(root, "backgrounds")
    os.makedirs(bg_dir)
    for i in range(4):
        write_png(os.path.join(bg_dir, f"bg_{i}.png"), rng.randint(0, 256, (H - H * i // 8, W - W * i // 6, 3)).astype(np.uint8))
    log(f"  set up in {time.perf_counter() - t_setup:.1f} s: {n_rows} codebook rows (latent "
        f"{emb.shape[1]}), {n_crops} crops, {n_frames} camera frames of {W}x{H}")

    # ---- the main path: counts from 0, read right after
    wrappers = (mc.grouped_codebook_top1, mc.grouped_codebook_topk, nq.cosine_top1_cuda, icp_nn.batched_nn_cuda)
    for fn in wrappers:
        fn.launches = 0
    secs = {}
    t0 = time.perf_counter()
    img_results = aae_image.main(["embed", "-f", crop_dir, "-o", os.path.join(root, "aae_image")], device=device)
    secs["aae_image"] = time.perf_counter() - t0
    web_cam, web_win, web_records = DemoCamera(cam_frames), DemoWindow(n_frames), []
    t0 = time.perf_counter()
    aae_webcam.main(["embed"], device=device, capture=web_cam, display=web_win, records=web_records)
    secs["aae_webcam"] = time.perf_counter() - t0
    det_cam, det_win, det_records = DemoCamera(det_frames), DemoWindow(n_frames), []
    t0 = time.perf_counter()
    detector_webcam_pose.main(det_argv, device=device, capture=det_cam, display=det_win, records=det_records)
    secs["detector_webcam_pose"] = time.perf_counter() - t0
    scene = eval_scene
    mesh = load_mesh(scene["ply"])
    vis_renderer = Renderer([], backend="native", meshes=[mesh])
    with open(os.path.join(scene["scene_dir"], "scene_gt_info.json")) as fh:
        gt_info = _json.load(fh)
    sK = scene["K"]
    s_hw = read_png(os.path.join(scene["scene_dir"], "rgb", f"{0:06d}.png")).shape[:2]

    def overlays(estimates, tag):
        out = []
        for im in range(scene["cpu_images"]):
            img = read_png(os.path.join(scene["scene_dir"], "rgb", f"{im:06d}.png"))
            mine = [(R, t) for i, R, t in estimates if i == im]
            est = []
            for R, t in mine:
                T = np.eye(4)
                T[:3, :3], T[:3, 3] = R, np.asarray(t).ravel()
                est.append(PoseEstimate(name="obj", trafo=T))
            boxes = [BoundingBox(xmin=x / s_hw[1], ymin=y / s_hw[0], xmax=(x + w) / s_hw[1], ymax=(y + h) / s_hw[0],
                                 classes={"obj": 1.0}) for x, y, w, h in (g["bbox_obj"] for g in gt_info[str(im)])]
            vis = PoseVisualizer(vis_renderer, {"obj": 0}).render_poses(img, sK, est, boxes, in_meters=False)
            path = plot_scene_with_3d_boxes(img, sK, mesh.vertices.min(axis=0), mesh.vertices.max(axis=0),
                                            [(R, np.asarray(t).ravel()) for R, t in mine],
                                            os.path.join(root, f"boxes_{tag}_{im}.png"))
            with open(path, "rb") as fh:
                out.append((vis, fh.read()))
        return out

    t0 = time.perf_counter()
    card_overlays = overlays(scene["card"], "card")
    secs["overlays"] = time.perf_counter() - t0
    gen = {}
    for name, cli, argv in (
        ("syn", generate_syn_det_train, ["--model_paths", scene["ply"], "--obj_ids", "1", "--vocdevkit_path", bg_dir,
                                         "--num_scenes", str(n_scenes), "--width", str(W), "--height", str(H),
                                         "--K", repr([float(v) for v in K.ravel()]), "--radius", str(cfg.radius),
                                         "--min_objects", "3", "--max_objects", "6"]),
        ("sixd", generate_sixd_train, ["--dataset_path", scene["data_root"], "--scenes", "1", "--vocdevkit_path",
                                       bg_dir, "--num_images", str(n_scenes), "--width", str(W), "--height", str(H),
                                       "--seed", str(seed)]),
    ):
        t0 = time.perf_counter()
        out_dir = os.path.join(root, f"gen_{name}")
        np.random.seed(seed)  # generate_syn_det_train draws from the global np.random, as the JAX CLI does
        gen[name] = cli.main(["--output_path", out_dir] + argv)
        secs[f"generate_{name}"] = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"  main-path launches: {launches}; seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    if str(device).startswith("cuda") and launches["cosine_top1_cuda"] < 1:
        raise AssertionError(f"B3 was not launched by the demo path: {launches}")

    torch.set_num_threads(os.cpu_count() or 1)
    # ---- aae_image
    if len(img_results) != n_crops:
        raise AssertionError(f"aae_image: {len(img_results)} results for {n_crops} crops")
    got = np.array([r["idx"] for r in img_results])
    want_files = sorted(os.path.join(crop_dir, f"view_{r:06d}.png") for r in rows)
    if [r["file"] for r in img_results] != want_files:
        raise AssertionError("aae_image: results out of the folder's order")
    with f32_without_tf32():
        z = card_cb.test_embedding(crops)
    own, best = np.sum(z * emb[rows], axis=1), np.sum(z * emb[got], axis=1)
    miss = (got != rows) & (own < best - MARGIN)
    if miss.any():
        raise AssertionError(f"aae_image: rows {rows[miss].tolist()} estimated as {got[miss].tolist()}")
    for r, crop in zip(img_results, crops):
        out = read_png(r["out_path"])
        if out.shape != (cfg.h, 2 * cfg.w, 3):
            raise AssertionError(f"aae_image: {r['out_path']} is {out.shape}")
        if not np.array_equal(r["R"], views[r["idx"]]) or not np.array_equal(out[:, :cfg.w], crop):
            raise AssertionError(f"aae_image: {r['out_path']}: rotation or input pane")
        if not np.array_equal(out[:, cfg.w:], dataset.render_rot(r["R"])):
            raise AssertionError(f"aae_image: {r['out_path']}: the estimate pane is not the render of its R")
    cpu_results = aae_image.main(["embed", "-f", cpu_dir, "-o", os.path.join(root, "aae_image_cpu")], device="cpu")
    if [r["idx"] for r in cpu_results] != got[:cpu_crops].tolist():
        raise AssertionError(f"aae_image: CPU rows {[r['idx'] for r in cpu_results]}, card {got[:cpu_crops].tolist()}")
    log(f"  aae_image: {n_crops} crops -> own row {int((got == rows).sum())}, a duplicate within {MARGIN} "
        f"{int((got != rows).sum())}; (128, 256) estimates, panes = renders of R; the first {cpu_crops} on the "
        f"CPU: the same rows")

    # ---- aae_webcam
    names = [n for n, _ in web_win.shown]
    if not web_cam.released or len(web_records) != n_frames or \
            names != ["resized webcam input", "estimated rendered view"] * n_frames:
        raise AssertionError(f"aae_webcam: released {web_cam.released}, {len(web_records)} frames, shown {names}")
    if web_cam.props != {3: 720, 4: 540}:
        raise AssertionError(f"aae_webcam: the camera was set to {web_cam.props}")
    web_crops = np.stack([r["crop"] for r in web_records])
    cpu_idx = np.asarray(cpu_cb.nearest_rotation(web_crops, return_idcs=True)).ravel()
    web_idx = np.array([r["idx"] for r in web_records])
    with f32_without_tf32():
        zc = cpu_cb.test_embedding(web_crops)
    ties = np.flatnonzero(web_idx != cpu_idx)
    for i in ties:
        gap = abs(float(zc[i] @ emb[web_idx[i]] - zc[i] @ emb[cpu_idx[i]]))
        if gap > MARGIN:
            raise AssertionError(f"aae_webcam frame {i}: card row {web_idx[i]}, CPU row {cpu_idx[i]} ({gap:.2e} apart)")
    for k, r in enumerate(web_records):
        pane = web_win.shown[2 * k + 1][1]
        if not np.array_equal(web_win.shown[2 * k][1], r["crop"]) or not np.array_equal(pane, dataset.render_rot(r["R"])):
            raise AssertionError(f"aae_webcam frame {k}: the panes are not the crop and the render of its R")
    log(f"  aae_webcam: {n_frames} frames, 2 panes each, the camera released; rows = the CPU port's "
        f"({len(ties)} ties within {MARGIN})")

    # ---- detector_webcam_pose
    if not det_cam.released or len(det_records) != n_frames:
        raise AssertionError(f"detector_webcam_pose: released {det_cam.released}, {len(det_records)} frames")
    cpu_est = AePoseEstimator(test_cfg, device="cpu")
    category_index = {1: {"id": 1, "name": "obj"}}
    pose_err, pose_ties, n_poses = 0.0, [], 0
    for k, r in enumerate(det_records):
        i = _frame_index(det_frames, r["frame"])
        want = remap_box_classes(ForegroundContourDetector(class_name="1", thresh=5).process(r["frame"]),
                                 category_index)
        if [(b.xmin, b.ymin, b.xmax, b.ymax, b.classes) for b in r["boxes"]] != \
                [(b.xmin, b.ymin, b.xmax, b.ymax, b.classes) for b in want] or len(want) != det_counts[i]:
            raise AssertionError(f"detector frame {k} (of {det_counts[i]} objects): boxes {r['boxes']}, want {want}")
        cpu_poses = cpu_est.process(bboxes=want, color_img=r["frame"], camK=K)
        if [p.name for p in r["poses"]] != [p.name for p in cpu_poses]:
            raise AssertionError(f"detector frame {k}: poses of {[p.name for p in r['poses']]}")
        n_poses += len(cpu_poses)
        for j, (p, q) in enumerate(zip(r["poses"], cpu_poses)):
            err = float(np.abs(p.trafo - q.trafo).max())
            if err <= DEMO_POSE_TOL:
                pose_err = max(pose_err, err)
                continue
            # a tie between two rows: the crop's CPU code as close to both
            crop = extract_square_patch_centered(r["frame"], want[j].to_xywh(W, H), cfg.pad_factor,
                                                 resize=(cfg.w, cfg.h), interpolation="linear", black_borders=True)
            with f32_without_tf32():
                cos = emb @ cpu_cb.test_embedding(crop).ravel()
            gap = float(cos.max() - np.sort(cos)[-2])
            if gap > MARGIN:
                raise AssertionError(f"detector frame {k} pose {j}: card vs CPU trafo {err:.2e} with a top-1 margin "
                                     f"of {gap:.2e}")
            pose_ties.append((k, j, err, gap))
        texts = np.zeros((H, W), bool)
        for q in cpu_poses:
            (tw, th), tb = draw.text_size(f"{q.name} z={q.trafo[2, 3]:.2f}m", 0.6, 2)
            texts[max(0, 20 - th - 2):20 + tb + 3, max(0, 10 - 2):10 + tw + 2] = True
        want_overlay = detector_webcam_pose.draw_overlay(r["frame"], want, cpu_poses)
        if ((r["overlay"] != want_overlay).any(-1) & ~texts).any():
            raise AssertionError(f"detector frame {k}: the overlay differs from the CPU's outside the labels")
        if not np.array_equal(det_win.shown[k][1], r["overlay"]):
            raise AssertionError(f"detector frame {k}: the window did not show the overlay")
    ms = {key: [r["ms"][key] for r in det_records] for key in ("detect", "estimate", "draw")}
    med = {key: float(np.median(v)) for key, v in ms.items()}
    log(f"  detector_webcam_pose: {n_frames} frames, {n_poses} poses; boxes = the detector's, poses within "
        f"{pose_err:.2e} of the CPU port's ({len(pose_ties)} ties within {MARGIN}: {pose_ties}); overlays = the "
        f"CPU's outside the labels; host ms a frame (median of {n_frames}, results on the host): detect "
        f"{med['detect']:.3f}, estimate {med['estimate']:.3f}, draw {med['draw']:.3f} (first frame "
        + ", ".join(f"{key} {v[0]:.3f}" for key, v in ms.items()) + ")")

    split = detector_split(det_frames, class_name="1", thresh=5)
    log(f"  ForegroundContourDetector.process alone on the {n_frames} frames (host ms, median of the frames' "
        f"medians of 5; the demo's detect above runs beside the pose stage and the grabber under the GIL): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))

    # ---- overlays of phase 8's scene
    cpu_overlays = overlays(scene["cpu"], "cpu")
    for im, ((cv, cpng), (wv, wpng)) in enumerate(zip(card_overlays, cpu_overlays)):
        if not np.array_equal(cv, wv) or cpng != wpng:
            raise AssertionError(f"overlays of scene image {im}: the card's estimates draw other pixels than the CPU's")
    log(f"  PoseVisualizer and plot_scene_with_3d_boxes on phase 8's first {scene['cpu_images']} images: the card's "
        f"estimates drawn = the CPU port's ({secs['overlays']:.2f} s)")

    # ---- the generators
    for name, out in gen.items():
        files = sorted(os.listdir(out["images"]))
        xmls = sorted(os.listdir(out["annotations"]))
        if len(files) != n_scenes or len(xmls) != n_scenes:
            raise AssertionError(f"generate_{name}: {len(files)} images, {len(xmls)} annotations")
        n_obj = 0
        for f, x in zip(files, xmls):
            img = read_png(os.path.join(out["images"], f))
            objs = parse_voc_xml(os.path.join(out["annotations"], x))
            n_obj += len(objs)
            if img.shape != (H, W, 3):
                raise AssertionError(f"generate_{name}: {f} is {img.shape}")
            for o in objs:
                x0, y0, x1, y1 = o["bb"]
                if not (0 <= x0 <= x1 <= W and 0 <= y0 <= y1 <= H):
                    raise AssertionError(f"generate_{name}: {x}: box {o['bb']} outside the {W}x{H} frame")
        if n_obj == 0:
            raise AssertionError(f"generate_{name}: no objects annotated")
        log(f"  generate_{name}: {n_scenes} images {W}x{H} with {n_obj} boxes inside the frame, PNG + VOC XML; "
            f"{secs[f'generate_{name}'] / n_scenes:.3f} s a scene")
    return {"launches": launches, "seconds": secs, "detector_ms": med, "detector_split_ms": split,
            "pose_err": pose_err,
            "pose_ties": len(pose_ties), "syn_s_per_scene": secs["generate_syn"] / n_scenes,
            "sixd_s_per_scene": secs["generate_sixd"] / n_scenes}


# ------------------------------------------------------------------ phase 13
def template_cfg(root, template_text):
    """The template's TrainConfig (written under `root` and read back)."""
    from augmentedautoencoder_torch.config import load_train_config

    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "template.cfg")
    with open(path, "w") as fh:
        fh.write(template_text)
    return load_train_config(path)


def ddp_w1_rank(device, cfg, seed, time_steps=0):
    """Rank function of phase 13 (a group of one rank): one train step of
    `make_train_step` with the mesh (DDP over the group) and one without
    it, each from the same seeded model and the same generator, with
    cuDNN's deterministic algorithms; whether loss, gradients and
    parameters are equal bit for bit. With `time_steps`, host ms a step
    of each at the cfg's batch (synchronized, after 3 warm-up steps), with
    cuDNN's default algorithms, as the Trainer runs."""
    import torch

    from augmentedautoencoder_torch.codebook import f32_without_tf32
    from augmentedautoencoder_torch.factory import build_train_model
    from augmentedautoencoder_torch.parallel import make_mesh
    from augmentedautoencoder_torch.parallel.dryrun import dryrun_dataset
    from augmentedautoencoder_torch.training import make_optimizer, make_train_step
    from augmentedautoencoder_torch.training.trainer import derive_seed

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ds = dryrun_dataset(cfg, device, n=256, n_bg=64, seed=seed)
    runs, ms = {}, {}
    for name, mesh in (("single", None), ("ddp", make_mesh())):
        model = build_train_model(cfg, device, seed)
        step = make_train_step(model, make_optimizer(model, cfg), ds, cfg.batch_size, mesh)
        with f32_without_tf32():
            torch.backends.cudnn.deterministic = True
            try:
                losses = step(torch.Generator(device=device).manual_seed(derive_seed(seed, 0)))
            finally:
                torch.backends.cudnn.deterministic = False
            runs[name] = {"loss": losses["total_loss"].cpu(),
                          "grads": {k: p.grad.cpu() for k, p in model.named_parameters()},
                          "params": {k: p.detach().cpu() for k, p in model.named_parameters()}}
            if time_steps:
                for s in range(3):
                    step(torch.Generator(device=device).manual_seed(derive_seed(seed, 100 + s)))
                sync()
                t0 = time.perf_counter()
                for s in range(time_steps):
                    step(torch.Generator(device=device).manual_seed(derive_seed(seed, 200 + s)))
                sync()
                ms[name] = 1e3 * (time.perf_counter() - t0) / time_steps
    a, b = runs["single"], runs["ddp"]
    equal = bool(torch.equal(a["loss"], b["loss"])) and all(
        torch.equal(a[part][k], b[part][k]) for part in ("grads", "params") for k in a[part])
    diff = max(float((a[part][k] - b[part][k]).abs().max()) for part in ("grads", "params") for k in a[part])
    return {"equal": equal, "max_diff": diff, "loss": float(a["loss"]), "tensors": len(a["grads"]), "ms": ms}


def embed_rank(device, views, batch_size):
    """Rank function of phase 13: `Codebook.build_embedding` over the data
    axis of the first `views` views of phase 13's experiment (its workspace
    in AE_WORKSPACE_PATH): host seconds of the build after the view sphere
    is computed, the split, and on the primary rank the rows and boxes."""
    from augmentedautoencoder_torch import factory, parallel
    from augmentedautoencoder_torch.codebook import Codebook

    cfg, paths, model, _ = factory.restore_experiment("embed", device=device, precision="float32")
    dataset = factory.build_dataset(paths["dataset_path"], cfg)
    dataset.viewsphere_for_embedding  # computed once per Dataset (~1 s at 92,232 rows): not a render
    parallel.barrier()
    split = {}
    t0 = time.perf_counter()
    emb, bbs = Codebook.build_embedding(factory.make_encode_fn(model), dataset.render_embedding_image_batch, views,
                                        batch_size, progress=False, device=device, profile=split,
                                        mesh=parallel.make_mesh())
    out = {"seconds": time.perf_counter() - t0, "split": split}
    if parallel.is_primary():
        out.update(emb=emb, bbs=bbs)
    return out


def one_process_embed(device, views, batch_size):
    """The same build in this process, without a mesh: (seconds, rows, boxes)."""
    from augmentedautoencoder_torch import factory
    from augmentedautoencoder_torch.codebook import Codebook

    cfg, paths, model, _ = factory.restore_experiment("embed", device=device, precision="float32")
    dataset = factory.build_dataset(paths["dataset_path"], cfg)
    dataset.viewsphere_for_embedding
    t0 = time.perf_counter()
    emb, bbs = Codebook.build_embedding(factory.make_encode_fn(model), dataset.render_embedding_image_batch, views,
                                        batch_size, progress=False, device=device)
    return time.perf_counter() - t0, emb, bbs


def _check_rows(name, got, want):
    import numpy as np

    dz = float(np.abs(got["emb"] - want[1]).max())
    if not dz <= EMBED_RANK_TOL or not np.array_equal(got["bbs"], want[2]):
        raise AssertionError(f"{name}: rows {dz:.2e} off the one-process build (> {EMBED_RANK_TOL}) or boxes differ")
    return dz


def multigpu_phase(root, device, template_text, n_rows=92_232, embed_views=1024, batch_size=256, seed=13,
                   time_steps=20, query_calls=50, cards=None):
    """Phase 13: the multi-GPU path on this machine's cards (see the module
    docstring); step 5 runs over `cards` ranks (default: every card, where
    there are two or more). Returns its summary; raises on any failed
    check."""
    import torch

    from augmentedautoencoder_torch.parallel import dryrun

    cfg = template_cfg(root, template_text)
    if cards is None:
        cards = torch.cuda.device_count() if device == "cuda" else 0
    summary = {"cards": cards}

    # 1. DDP at W = 1 (NCCL on a card) against the one-process step
    w1 = dryrun.run_ranks(ddp_w1_rank, 1, device, cfg, seed, time_steps if cards >= 2 else 0)[0]
    summary["w1"] = w1
    if not w1["equal"]:
        raise AssertionError(f"DDP at W = 1 differs from the one-process step by up to {w1['max_diff']:.3e}")
    backend1 = dryrun.rank_devices(1, device)[1]
    log(f"  DDP at W = 1 over {backend1}: loss, {w1['tensors']} gradients and parameters equal the one-process "
        f"step bit for bit (batch {cfg.batch_size}, loss {w1['loss']:.6f})")

    # 2-3. two ranks: full-width train steps against the one-process step, and
    # the row-sharded queries (the main path: each rank counts its sharded
    # calls only, from 0)
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multigpu(2, device, cfg=cfg, steps=2, seed=seed, n_rows=n_rows, query_calls=query_calls)
    summary["dryrun2"] = dry
    worst = {k: max(c[k] for c in dry["steps"]) for k in ("loss_rel", "grad_rel", "update_err", "stat_err")}
    where = "on the CPU" if device == "cpu" else ("sharing card 0" if dry["backend"] == "gloo" else "a card each")
    log(f"  2 ranks over {dry['backend']} ({where}), batch "
        f"{cfg.batch_size} ({cfg.batch_size // 2} a rank), {len(dry['steps'])} steps against one process from the "
        f"same state: loss rel {worst['loss_rel']:.2e} (<= {dryrun.LOSS_RTOL}), gradients {worst['grad_rel']:.2e} of "
        f"their largest (<= {dryrun.GRAD_RTOL}), update given the same gradients {worst['update_err']:.2e} "
        f"(<= {dryrun.UPDATE_TOL}); ranks' parameters equal; {time.perf_counter() - t0:.1f} s")
    launches = {}
    for dtype, q in dry["queries"].items():
        for name, n in q["launches"].items():
            launches[name] = launches.get(name, 0) + n
        log(f"  sharded queries, {n_rows} rows {dtype} over 2 ranks against the replicated kernel: values within "
            f"{q['max_abs_err']:.2e}, {q['ties']} index differences inside the margin {MARGIN}, the cross-shard tie "
            f"to the lower row; host ms a call (rank 0, {query_calls} calls): "
            + ", ".join(f"{k} {v:.3f}" for k, v in (q["host_ms_per_call"] or {}).items()))
    summary["launches"] = launches
    log(f"  main-path launches (the sharded calls, summed over the ranks): {launches}")
    if device == "cuda" and (launches["cosine_top1_cuda"] < 1 or launches["grouped_codebook_topk"] < 1):
        raise AssertionError(f"B3 or B2 was not launched by the sharded queries: {launches}")

    # 4. the sharded embed of the first views against the one-process rows
    embed_experiment(os.path.join(root, "embed"), template_text)
    want = one_process_embed(device, embed_views, batch_size)
    got = dryrun.run_ranks(embed_rank, 2, device, embed_views, batch_size)
    dz = _check_rows("sharded embed", got[0], want)
    summary["embed2"] = {"max_dz": dz, "seconds": [g["seconds"] for g in got], "one_process_s": want[0]}
    log(f"  sharded embed of {embed_views} views over 2 ranks: rows within {dz:.2e} of the one-process build, "
        f"boxes equal; {max(g['seconds'] for g in got):.2f} s (one process {want[0]:.2f} s)")

    # 5. every card, where there are several
    if cards >= 2:
        t0 = time.perf_counter()
        big = dryrun.dryrun_multigpu(cards, device, cfg=cfg, steps=2, seed=seed, n_rows=n_rows,
                                     time_steps=time_steps, query_calls=query_calls)
        summary["dryrun_all"] = big
        ms = big["ms_per_step"]
        log(f"  {cards} ranks over {big['backend']}: checks as above ({time.perf_counter() - t0:.1f} s); host ms a "
            f"step ({time_steps} steps, synchronized): global batch {cfg.batch_size} {ms['global']:.3f}, "
            f"{cfg.batch_size} a rank (global {cfg.batch_size * cards}) {ms['per_rank']:.3f}; one card, one "
            f"process, batch {cfg.batch_size}: {w1['ms']['single']:.3f} (DDP at W = 1 {w1['ms']['ddp']:.3f})")
        for dtype, q in big["queries"].items():
            log(f"  sharded queries {dtype} over {cards} ranks: values within {q['max_abs_err']:.2e}; host ms a "
                "call: " + ", ".join(f"{k} {v:.3f}" for k, v in q["host_ms_per_call"].items()))
        views = n_rows
        one = one_process_embed(device, views, batch_size)
        got = dryrun.run_ranks(embed_rank, cards, device, views, batch_size)
        dz = _check_rows(f"sharded embed over {cards} ranks", got[0], one)
        secs = max(g["seconds"] for g in got)
        summary["embed_all"] = {"views": views, "seconds": secs, "views_per_s": views / secs,
                                "one_process_s": one[0], "one_process_views_per_s": views / one[0], "max_dz": dz,
                                "splits": [g["split"] for g in got]}
        log(f"  embed of {views} views over {cards} ranks: {secs:.1f} s = {views / secs:.1f} views/s (one process "
            f"in this call: {one[0]:.1f} s = {views / one[0]:.1f} views/s); rows within {dz:.2e}, boxes equal; "
            "rank 0's split (s): " + ", ".join(f"{k} {v:.2f}" for k, v in got[0]["split"].items()
                                               if isinstance(v, float)))
    return summary


def main() -> int:
    start = time.perf_counter()
    seconds = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = phase("1 device", device_phase)
    sys.path.insert(0, REPO)
    import torch

    log("phase 2: build")
    phase("2 build", build_phase)
    log(f"phase 3: kernels vs plain versions (values within {VAL_TOL}; indices equal where "
        f"the plain ranking's margin exceeds {MARGIN}; B4 identical; times: median of 20, cold L2)")
    t0 = time.perf_counter()
    errs, records = kernel_phase()
    for name, err in width_phase().items():
        errs[name] = max(errs[name], err)
    errs["batched_nn_cuda"], records["batched_nn_cuda"] = nn_phase()
    seconds["3 kernels"] = time.perf_counter() - t0
    with open(TEMPLATE) as fh:
        template = fh.read()
    with tempfile.TemporaryDirectory(prefix="aae_chip_smoke_") as root:
        log(f"phase 4: serving at full width ({time.perf_counter() - start:.1f} s in)")
        summary = phase("4 serving", serving_phase, os.path.join(root, "rgb"), "cuda", template)
        log(f"phase 5: depth-refined serving at full width ({time.perf_counter() - start:.1f} s in)")
        depth = phase("5 depth", depth_phase, os.path.join(root, "depth"), "cuda", template)
        log(f"phase 6: codebook embedding at full width ({time.perf_counter() - start:.1f} s in)")
        embed = phase("6 embed", embed_phase, os.path.join(root, "embed"), "cuda", template)
        log(f"phase 7: training at full width ({time.perf_counter() - start:.1f} s in); first the decoder's fused "
            f"2x convolution against its plain form (within {UPCONV_RTOL} of each tensor's largest, f64 reference)")
        t0 = time.perf_counter()
        upconv_phase(os.path.join(root, "upconv"), template)
        train = train_phase(os.path.join(root, "train"), "cuda", template)
        seconds["7 train"] = time.perf_counter() - t0
        log(f"phase 7b: training in PRECISION bfloat16 at full width ({time.perf_counter() - start:.1f} s in)")
        train_bf16 = phase("7b train bf16", bf16_train_phase, os.path.join(root, "train"), "cuda", train)
        log(f"phase 8: evaluation at full width ({time.perf_counter() - start:.1f} s in)")
        evaluation = phase("8 eval", eval_phase, os.path.join(root, "eval"), "cuda", template)
        log(f"phase 9: dsprites at the template's width, 64x64x1 ({time.perf_counter() - start:.1f} s in)")
        sprites = phase("9 dsprites", dsprites_phase, os.path.join(root, "dsprites"), "cuda", template)
        log(f"phase 10: jpeg ({time.perf_counter() - start:.1f} s in)")
        phase("10 jpeg", jpeg_phase)
        with tempfile.TemporaryDirectory(prefix="aae_chip_smoke_import_") as import_root:
            log(f"phase 11: ae_import_tf of the committed TF1 checkpoint, served "
                f"({time.perf_counter() - start:.1f} s in)")
            imported = phase("11 import", import_phase, import_root, "cuda")
        log(f"phase 12: the demos and the detector-data generators on phase 6's experiment "
            f"({time.perf_counter() - start:.1f} s in)")
        demo = phase("12 demo", demo_phase, os.path.join(root, "demo"), "cuda", template, embed["workspace"],
                     evaluation["scene"])
        log(f"phase 13: multi-GPU ({torch.cuda.device_count()} card(s); {time.perf_counter() - start:.1f} s in)")
        multi = phase("13 multi-GPU", multigpu_phase, os.path.join(root, "multi_gpu"), "cuda", template)
    log(f"all phases passed in {time.perf_counter() - start:.1f} s; seconds per phase: "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))

    kernels = []
    for name, source, replaces, launches in (
        ("grouped_codebook_top1", CODEBOOK_SOURCE, "augmentedautoencoder_tpu/ops/multi_codebook.py:72",
         summary["launches"]),
        ("grouped_codebook_topk", CODEBOOK_SOURCE, "augmentedautoencoder_tpu/ops/multi_codebook.py:214",
         summary["launches"]),
        ("cosine_top1_cuda", CODEBOOK_SOURCE, "augmentedautoencoder_tpu/ops/nn_query.py:113",
         summary["launches"]),
        ("batched_nn_cuda", NN_SOURCE, "augmentedautoencoder_tpu/ops/icp_nn.py:165", depth["launches"]),
    ):
        rec = dict(records[name])
        bound, bound_by = bound_ms(rec.pop("n_bytes"), rec.pop("flops"), rec.pop("peak"))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": rec.pop("ms"), "plain_ms": rec.pop("plain_ms"), "bound_ms": bound, "bound_by": bound_by,
            "library_ms": rec.pop("library_ms"),
            "launches_by_path": {"rgb_serving": summary["launches"].get(name, 0),
                                 "depth_serving": depth["launches"][name],
                                 "embed": embed["launches"][name],
                                 "train": train["launches"][name],
                                 "train_bf16": train_bf16["launches"][name],
                                 "eval": evaluation["launches"][name],
                                 "dsprites": sprites["launches"][name],
                                 "import": imported["launches"][name],
                                 "demo": demo["launches"][name],
                                 "multi_gpu": multi["launches"][name]},
            "timed": {"ms": "device, whole function from the user's inputs, cold L2",
                      "launch_ms": "device, kernel binding on operands in its input form, cold L2",
                      "call_ms": "host clock per call of the whole function, back to back, warm L2, "
                                 "median of runs taken in turns"},
            **rec,
        })
        log(f"{name}: times at {rec['shape']}; launches from phase "
            f"{5 if launches is depth['launches'] else 4}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
