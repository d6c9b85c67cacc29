#!/usr/bin/env python3
"""chip_smoke.py's multi-GPU phase alone, on every CUDA card of the host.

    python3 scripts/chip_multi_gpu.py [--out summary.json]

Runs chip_smoke.py's phase 1 (the cards' names and power limits), phase 2
(the kernels' build) and phase 13 (`multigpu_phase`): DDP at W = 1 over
NCCL bit for bit, two ranks against one process at the template's width,
the row-sharded B3 / B2 queries on a 92,232-row codebook, a 2-rank embed of
1,024 views and, with two or more cards, the same over every card with
ms/step at global batch 64 and at 64 a rank beside one process, and the
92,232-view embed over every card beside one process. This is the
multi-card proof run (a host of four H100s); `python3 chip_smoke.py` runs
phase 13 after the others on one card. Writes the phase's summary as JSON
to --out; imports no jax.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(prog="chip_multi_gpu")
    parser.add_argument("--out", default=None, help="where to write the summary (JSON)")
    args = parser.parse_args()
    t0 = time.perf_counter()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout
    print(cards.strip(), f"\nhost: {os.cpu_count()} CPUs", flush=True)
    chip_smoke.device_phase()
    chip_smoke.build_phase()
    with open(chip_smoke.TEMPLATE) as fh:
        template = fh.read()
    with tempfile.TemporaryDirectory(prefix="aae_multi_gpu_") as root:
        summary = chip_smoke.multigpu_phase(root, "cuda", template)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(summary, fh, default=str, indent=1)
    print(f"phase 13 passed; {time.perf_counter() - t0:.1f} s with the build", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
