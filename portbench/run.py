"""Run one benchmark cell of the PyTorch port once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads`; its configuration, traffic mix, limits and per-layer metric
readers are found by name under portbench/ (README.md). With --trace 0
the result carries the cell's end-to-end metrics, with --trace 1 its
per-layer metrics. The last line of standard output is the result, one
JSON object; the numbers compared for `correct` and their limits are the
last lines of standard error and the result's last key.

A cell on one card runs in this process on cuda:0. A cell on N > 1
cards runs as N ranks, one process a card with torchrun's variables, each
pinned to cuda:LOCAL_RANK; this process starts them, waits for them and
prints the one result from their records: rank 0's metrics and checks,
the count of distinct cards the ranks ran on (by UUID), the fullest card's
peak memory, rank 0's card and power limit and the least power limit.

Without a CUDA device, or with fewer than the cell asks for, it exits
with code 2 and prints no result; likewise when the JAX package, JAX or
TensorFlow has been loaded by the time the window closes, in this process
or in any rank, and when two ranks ran on one card. When a rank exits with
another code than 0, or the ranks outlive RANK_LIMIT_S past the window,
every rank is ended and the run exits with code 1 and prints no result.
"""

import time

T_START = time.perf_counter()
#: the same moment on the clock that every process of the machine shares,
#: from which the ranks of a multi-card cell count their set-up
T_START_SHARED = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
#: top-level modules that must not be loaded: JAX, its libraries, TensorFlow, the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "tensorflow", "augmentedautoencoder_tpu")
#: the ranks of a multi-card cell are ended once they outlive the window by this
RANK_LIMIT_S = 900.0
#: where a rank finds the launcher's start on the shared clock
SHARED_START_ENV = "PORTBENCH_T_START"


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_files(manifest: dict, name: str):
    """(workload entry, configuration, traffic mix, limits) of cell `name`."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _load(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = _load(os.path.join(BENCH, "traffic", cell["traffic"] + ".json"))
    limits = {k: v["limit"] for k, v in _load(os.path.join(BENCH, "limits", name + ".json")).items()}
    return cell, config, traffic, limits


def metrics_of(manifest: dict, cell: str, trace: bool, out: dict) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer metrics (traced),
    each per-layer one from its reader `metrics/<name>.py`; a reader that
    finds nothing to read leaves its metric out."""
    metrics = {}
    for m in manifest["per_layer" if trace else "end_to_end"]:
        if cell not in m.get("workloads", [cell]):
            continue
        if trace:
            spec = importlib.util.spec_from_file_location(
                "portbench.metrics." + m["name"], os.path.join(BENCH, "metrics", m["name"] + ".py"))
            reader = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(reader)
            value = reader.read(out["readings"])
        else:
            value = out["end_to_end"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def power_limit_w(index):
    """The card's power limit from nvidia-smi (`index`: its number or its
    `GPU-<uuid>`), or None where it cannot be read."""
    try:
        proc = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
                               "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=30)
        return float(proc.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def _finite(x):
    """`x` with each non-finite float written as a string ("inf", "nan")."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def forbidden_modules():
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def run_cell(manifest, cell, config, traffic, limits, seed, seconds, trace, device, t_start=T_START) -> dict:
    """One run of `cell` on `device`: the result object (without printing)."""
    import torch

    kind = importlib.import_module("portbench.kinds." + traffic["kind"])
    out = kind.run(config, traffic, seed, seconds, trace, device, os.path.join(BENCH, "_data"), limits, t_start)
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index or 0
        record = {"platform": "gpu", "kind": torch.cuda.get_device_name(index), "count": 1,
                  "memory_peak_bytes": out["memory_peak_bytes"], "power_limit_w": power_limit_w(index)}
    else:
        record = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return result_of(manifest, cell, trace, kind, out, record)


def result_of(manifest, cell, trace, kind, out, record) -> dict:
    """The result object of a run's output `out`, with the device `record`."""
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics_of(manifest, cell["name"], trace, out), "device": record}
    if trace:
        t = out["readings"].trace
        record["busy_s"] = t.busy_us() / 1e6
        record["window_s"] = t.window_us / 1e6
        result["breakdown"] = kind.breakdown(t)
    result["notes"] = out["notes"]
    result["checks"] = out["checks"]
    return result


def card_record(index: int, peak: int) -> dict:
    """The card a rank ran on: its UUID, name, peak memory and power limit."""
    import torch

    uuid = str(torch.cuda.get_device_properties(index).uuid)
    return {"uuid": uuid, "kind": torch.cuda.get_device_name(index), "memory_peak_bytes": int(peak),
            "power_limit_w": power_limit_w("GPU-" + uuid)}


def _die_with_the_launcher() -> None:
    """Have the kernel kill this rank if the process that started it dies
    (Linux's PR_SET_PDEATHSIG), so that no rank outlives its run."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (AttributeError, OSError):
        pass


def run_rank(manifest, cell, config, traffic, limits, args) -> int:
    """This process as one rank of a multi-card cell: its share of the run
    on cuda:LOCAL_RANK, and its record written to `args.record`."""
    import torch

    _die_with_the_launcher()
    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    kind = importlib.import_module("portbench.kinds." + traffic["kind"])
    out = kind.run(config, traffic, args.seed, args.seconds, bool(args.trace), torch.device("cuda", local),
                   os.path.join(BENCH, "_data"), limits, float(os.environ[SHARED_START_ENV]))
    record = {"rank": rank, "card": card_record(local, out["memory_peak_bytes"]), "forbidden": forbidden_modules()}
    if rank == 0:
        record["result"] = _finite(result_of(manifest, cell, bool(args.trace), kind, out, {}))
    tmp = args.record + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(record, fh, allow_nan=False)
    os.replace(tmp, args.record)
    return 0


def _exit_on_sigterm(signum, frame):
    raise SystemExit(128 + signum)


def enough_cards(cell, workload: str) -> bool:
    """Whether CUDA sees the cards the cell asks for; says so where not."""
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= cell["chips"]:
        return True
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"portbench: {workload} needs {cell['chips']} CUDA device(s), found {n}", file=sys.stderr)
    return False


def run_ranks(cell, args) -> tuple:
    """(result, None) of a cell on `cell["chips"]` cards, one rank a card,
    or (None, exit code) where a rank failed or the records refuse it. The
    ranks start first; this process looks for the cards (importing torch)
    while they start, and ends them where there are too few."""
    from portbench import ranks

    world = cell["chips"]
    previous = signal.signal(signal.SIGTERM, _exit_on_sigterm)  # a SIGTERM ends the ranks with this process
    try:
        with tempfile.TemporaryDirectory(prefix="portbench-ranks-") as tmp:
            port = ranks.free_port()
            paths = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
            command = [sys.executable, os.path.abspath(__file__), "--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", repr(args.seconds), "--trace", str(args.trace)]
            envs = [ranks.rank_env(os.environ, r, world, port, {SHARED_START_ENV: repr(T_START_SHARED)})
                    for r in range(world)]
            code = ranks.supervise([command + ["--record", p] for p in paths], envs, RANK_LIMIT_S + args.seconds,
                                   log=lambda m: print(m, file=sys.stderr, flush=True),
                                   first=lambda: None if enough_cards(cell, args.workload) else 2)
            if code:
                return None, code
            records = []
            for p in paths:
                with open(p) as fh:
                    records.append(json.load(fh))
    finally:
        signal.signal(signal.SIGTERM, previous)
    result, why = ranks.assemble(records, world)
    if why:
        print(f"portbench: {why}", file=sys.stderr)
        return None, 2
    return result, None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the launcher of a multi-card cell: this process is one rank, its record goes there
    parser.add_argument("--record", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    manifest = _load(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic, limits = cell_files(manifest, args.workload)

    # every build and kernel cache of the run inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(BENCH, "_cache", sub)
    if cell["chips"] > 1 and not args.record:
        result, code = run_ranks(cell, args)
        if result is None:
            return code
    elif not enough_cards(cell, args.workload):
        return 2
    elif args.record:
        return run_rank(manifest, cell, config, traffic, limits, args)
    else:
        result = run_cell(manifest, cell, config, traffic, limits, args.seed, args.seconds, bool(args.trace),
                          "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
