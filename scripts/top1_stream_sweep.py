#!/usr/bin/env python3
"""Where the time of the streaming top-1 goes, on one CUDA card.

    python3 scripts/top1_stream_sweep.py

Launches csrc/codebook_query.cu aae_codebook_top1_stream directly at the
serving shape (a 92,232 x 128 codebook, B = 8; B = 1 and 64 as well), f32
and bf16, and times each launch by CUDA events (median of 20) in three
cache states:
  dirty -- L2 evicted by writing 256 MB (chip_smoke.py's protocol: the
           evicted lines are dirty, so the kernel's reads also pay their
           write-back to HBM);
  clean -- L2 evicted by reading 256 MB;
  warm  -- no eviction (the codebook mostly in L2).
Beside the plan's launch shape it times the same launch with no row read
(n_valid = 0: scoring, launch and merge only), with one tile per block
(264 tiles: launch, first-tile latency and merge), other tile sizes, ring
depths and grid sizes, one tiny PyTorch kernel (the cost of any launch
under this timing) and the query normalization the wrappers run before the
kernel. Needs the CUDA toolkit (nvcc); imports no jax.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from augmentedautoencoder_torch.ops import _cuda  # noqa: E402
from augmentedautoencoder_torch.ops.nn_query import l2_normalize  # noqa: E402

N, D = 92_232, 128


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("top1_stream_sweep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _cuda.lib()
    dev = torch.device("cuda")
    sms, smem = _cuda.sm_count(0), _cuda.smem_limits(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cb32 = l2_normalize(torch.randn((N, D), generator=gen, device=dev))
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    sink = torch.empty((1, flush.shape[0] // 1024), device=dev)
    state = torch.zeros(4096, dtype=torch.int64, device=dev)

    def launch(q, cb, n_rows, n_valid, rows, stages, qpt, n_blocks):
        b = q.shape[0]
        out = torch.empty((2, b), dtype=torch.int32, device=dev)
        rc = lib.aae_codebook_top1_stream(
            q.data_ptr(), cb.data_ptr(), int(cb.dtype == torch.bfloat16), 0, N, n_rows, n_valid, b, D,
            min(b, _cuda.TOP1_Q), qpt, rows, stages, n_blocks, state.data_ptr(), out.data_ptr(),
            out.data_ptr() + 4 * b, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return out

    def device_ms(fn, mode, reps=20):
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(reps):
            if mode == "dirty":
                flush.zero_()
            elif mode == "clean":
                torch.sum(flush.view(1024, -1), dim=0, keepdim=True, out=sink)
            torch.cuda._sleep(1_000_000)  # the host issues the call before the start event is reached
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        ms = sorted(s.elapsed_time(e) for s, e in pairs)
        return ms[len(ms) // 2]

    def row(name, fn):
        print(f"{name:58s} " + " ".join(f"{m} {device_ms(fn, m):.4f}" for m in ("dirty", "clean", "warm"))
              + " ms", flush=True)

    for dtype in (torch.float32, torch.bfloat16):
        cb = cb32.to(dtype)
        elem = cb.element_size()
        for b in (8, 1, 64):
            z = torch.randn((b, D), generator=gen, device=dev)
            q = l2_normalize(z).to(dtype).contiguous()
            p = _cuda.plan_top1_stream(b, N, D, elem, sms, smem)
            tag = f"{str(dtype)[6:]} B={b}"
            row(f"{tag} plan: {p.rows_per_tile} rows, {p.stages} stages, qpt {p.qpt}",
                lambda: launch(q, cb, N, N, p.rows_per_tile, p.stages, p.qpt, p.n_blocks))
            if b != 8:
                continue
            row(f"{tag} plan, no row read (n_valid 0)",
                lambda: launch(q, cb, N, 0, p.rows_per_tile, p.stages, p.qpt, p.n_blocks))
            one = 2 * sms * p.rows_per_tile
            row(f"{tag} plan, one tile per block", lambda: launch(q, cb, one, one, p.rows_per_tile, p.stages,
                                                                  p.qpt, 2 * sms))
            row(f"{tag} one tiny PyTorch kernel", lambda: sink.add_(1.0))
            row(f"{tag} the wrappers' query normalization", lambda: l2_normalize(z.float()).to(dtype).contiguous())
            for rows in ((32, 64) if elem == 4 else (64, 128)):
                for stages in (2, 3, 4):
                    if 2 * (_cuda.top1_smem_bytes(stages, rows, D * elem, 8, D) + smem.reserved) > smem.per_sm:
                        continue
                    for n_blocks in (sms, 2 * sms):
                        row(f"{tag} {rows} rows, {stages} stages, {n_blocks} blocks",
                            lambda: launch(q, cb, N, N, rows, stages, p.qpt, n_blocks))
    return 0


if __name__ == "__main__":
    sys.exit(main())
