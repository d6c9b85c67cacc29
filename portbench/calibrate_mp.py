"""The readings that a multi-path cell's limits are set from (not run by
run.py):

    python3 portbench/calibrate_mp.py --workload <cell> --seeds 1,2,.. [--control-seeds ..] [--fault-seeds ..]

On one card, on the cell's own sizes, for each seed:

  sound    the program's checked steps against the reference
  control  the reference with its operands one precision below the
           configuration's (`reference/lowp.py`) in the program's place
  faults   the program with its timed path broken underneath:
           half_batch  the step's batch cut to its first half, the mean
                       taken over the rest
           unchanged   an optimizer step that leaves the state unchanged
           misrouted   object o's rows decoded by decoder (o + 1) mod n_o

Each reading compares every object's decoder with its own
(`kinds/train_mp.compare_objects`). It prints one JSON line a reading,
then a summary with, per number, the largest sound reading (the lower
reading) and the smallest control and fault readings, and writes them to
--out when given. (`calibrate.py` reads the one-object kinds.)
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("half_batch", "unchanged", "misrouted")


def misroute(bank) -> None:
    """Break `bank` (a `DecoderBank`) so that object o's rows are decoded by
    decoder (o + 1) mod n_o: its input rows rolled one object forward, its
    output rolled back."""
    whole = bank.forward

    def forward(z):
        b = z.shape[0] // bank.n_objects
        return whole(z.roll(b, 0)).roll(-b, 0)

    bank.forward = forward


def readings(cell_name, seeds, control_seeds, fault_seeds, device, config=None, traffic=None, data_dir=None):
    """The readings as a list of {"kind", "seed", numbers...}."""
    import torch

    from portbench.kinds import train, train_mp
    from portbench.reference import compare, lowp
    from portbench.run import BENCH, _load, cell_files

    if config is None:
        _, config, traffic, _ = cell_files(_load(os.path.join(ROOT, "BENCHMARK.json")), cell_name)
        data_dir = os.path.join(BENCH, "_data")
    n_objects = train_mp.n_objects_of(config)
    out, pool = [], None

    def program(seed, fault=None):
        nonlocal pool
        trainer, recorder, pool = train_mp.build(config, traffic, seed, device, data_dir, pool)
        if fault == "half_batch":
            whole = trainer.dataset.sample_batch
            trainer.dataset.sample_batch = lambda gen, b, shard=(0, 1): tuple(
                t[: t.shape[0] // 2] for t in whole(gen, b, shard))
        elif fault == "unchanged":
            trainer.optimizer.step = lambda: None
        elif fault == "misrouted":
            misroute(trainer.model.decoder)
        rec = train.check_steps(trainer, recorder, traffic["check_steps"])
        del trainer
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return rec

    def reference(seed, rounding=None):
        return train_mp.reference(config, traffic, seed, device, pool, rounding)

    def add(kind, seed, rec, ref):
        rec, ref = train_mp.per_object(rec, n_objects), train_mp.per_object(ref, n_objects)
        row = {"kind": kind, "seed": seed, **compare.compare(rec, ref), **compare.details(rec, ref)}
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
        for fault in FAULTS:
            rec = program(seed, fault)
            ref = ref or reference(seed)
            add(fault, seed, rec, ref)
    return out


def main(argv=None):
    from portbench.calibrate import _seeds, summary

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--fault-seeds", type=_seeds, default=[])
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate_mp: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    rows = readings(args.workload, args.seeds, args.control_seeds, args.fault_seeds, torch.device("cuda", 0))
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
