"""The readings that a cell's limits are set from (not run by run.py):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,.. [--control-seeds ..] [--fault-seeds ..]

and for a cell on N cards, one rank a card under torchrun:

    python3 -m torch.distributed.run --nproc_per_node=N portbench/calibrate.py --workload <cell> ...

In one process (rank 0 reads and prints; the other ranks step beside it),
on the cell's own sizes, for each seed:

  sound    the program's checked steps against the reference
  control  the reference with its operands one precision below the
           configuration's (`reference/lowp.py`) in the program's place
  faults   the program with its timed path broken underneath:
           half_batch  the step's batch cut to its first half, the mean
                       taken over the rest
           unchanged   an optimizer step that leaves the state unchanged
           no_allreduce  (over several ranks) every rank steps on its own
                       slice's gradient, DDP's all-reduce skipped

It prints one JSON line a reading, then a summary with, per number, the
largest sound reading (the lower reading) and the smallest control and
fault readings, and writes them to --out when given.
"""

import argparse
import inspect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def readings(cell_name, seeds, control_seeds, fault_seeds, device, config=None, traffic=None, data_dir=None):
    """The readings as a list of {"kind", "seed", numbers...}."""
    import torch

    from portbench.kinds import train, train_ddp
    from portbench.reference import compare, lowp
    from portbench.run import BENCH, _load, cell_files

    if config is None:
        cell, config, traffic, _ = cell_files(_load(os.path.join(ROOT, "BENCHMARK.json")), cell_name)
        data_dir = os.path.join(BENCH, "_data")
    out, pool = [], None
    ranks = traffic["kind"] == "train_ddp"
    primary = True
    if ranks:
        from augmentedautoencoder_torch.parallel import distributed

        distributed.initialize(device=device)
        primary = distributed.is_primary()
    faults = ("half_batch", "unchanged") + (("no_allreduce",) if ranks else ())

    def program(seed, fault=None):
        nonlocal pool
        if ranks and pool is None:
            pool = train_ddp.load_pool(config, traffic, data_dir)
        trainer, recorder, pool = train.build(config, traffic, seed, device, data_dir, pool)
        if fault == "half_batch":
            whole = trainer.dataset.sample_batch
            trainer.dataset.sample_batch = lambda gen, b, shard=(0, 1): tuple(
                t[: t.shape[0] // 2] for t in whole(gen, b, shard))
        elif fault == "unchanged":
            trainer.optimizer.step = lambda: None
        elif fault == "no_allreduce":
            inspect.getclosurevars(trainer.step_fn).nonlocals["model"].require_backward_grad_sync = False
        rec = train.check_steps(trainer, recorder, traffic["check_steps"])
        if ranks:
            rec["ranks_unlike"] = train_ddp.ranks_unlike(trainer)
        del trainer
        return rec

    def reference(seed, lowp=None):
        return train.reference(config, traffic, seed, device, pool, lowp) if primary else None

    def add(kind, seed, rec, ref):
        if not primary:
            return
        row = {"kind": kind, "seed": seed, **compare.compare(rec, ref), **compare.details(rec, ref)}
        if "ranks_unlike" in rec:
            row["ranks_unlike"] = rec["ranks_unlike"]
        print(json.dumps(row), flush=True)
        out.append(row)

    control = lowp.operand_rounding(lowp.CONTROL_OF[train.precision_of(config)])
    for seed in seeds:
        rec = program(seed)
        add("sound", seed, rec, reference(seed))
    for seed in control_seeds:
        if pool is None:
            program(seed)
        add("control", seed, reference(seed, control), reference(seed))
    for seed in fault_seeds:
        ref = None
        for fault in faults:
            rec = program(seed, fault)
            ref = ref or reference(seed)
            add(fault, seed, rec, ref)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if ranks:
        distributed.barrier()
        distributed.shutdown()
    return out


def summary(rows):
    from portbench.reference.compare import NUMBERS

    kinds = sorted({r["kind"] for r in rows})
    pick = {k: (max if k == "sound" else min) for k in kinds}
    return {k: {n: pick[k](r[n] for r in rows if r["kind"] == k) for n in NUMBERS} for k in kinds}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--fault-seeds", type=_seeds, default=[])
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))  # torchrun's, for a rank
    rows = readings(args.workload, args.seeds, args.control_seeds, args.fault_seeds, device)
    if int(os.environ.get("RANK", "0")):
        return 0
    result = {"workload": args.workload, "device": torch.cuda.get_device_name(0), "seconds": time.perf_counter() - t0,
              "rows": rows, "summary": summary(rows)}
    print(json.dumps(result["summary"]))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
