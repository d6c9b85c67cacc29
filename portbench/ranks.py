"""The ranks of a multi-card cell: one process a card, started with the
variables torchrun gives its workers, supervised until every one has
ended, and their records assembled into the run's one result.

A rank's record (JSON, written by `run.py` in the rank) holds its `rank`,
its `card` (`uuid`, `kind`, `memory_peak_bytes`, `power_limit_w`), the
forbidden modules it had loaded once its window had closed (`forbidden`),
and on rank 0 the run's `result`.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(base: Dict[str, str], rank: int, world: int, port: int, extra: Dict[str, str]) -> Dict[str, str]:
    """The environment of rank `rank` of `world` on one host, as torchrun
    sets it (one intra-op thread a rank unless OMP_NUM_THREADS is set)."""
    env = dict(base, WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), **extra)
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def _end(proc: subprocess.Popen) -> None:
    """Kill the rank's whole session (it may have started processes of its own)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def supervise(commands: Sequence[List[str]], envs: Sequence[Dict[str, str]], limit_s: float,
              log=print, first=None, poll_s: float = 0.1) -> int:
    """Start one process a command, each in a session of its own with its
    standard output sent to standard error, and wait. `first()`, called
    once they have started, may return an exit code that ends them at once.
    0 when every one exits with 0; 1 as soon as one exits otherwise, or
    when any is still running after `limit_s` seconds: the others are then
    killed. No process is left running on return, whatever ends the wait."""
    procs = []
    try:
        for cmd, env in zip(commands, envs):
            procs.append(subprocess.Popen(cmd, env=env, stdout=2, start_new_session=True))
        code = first() if first else None
        if code is not None:
            return code
        deadline = time.monotonic() + limit_s
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                log(f"portbench: rank {bad[0][0]} exited with code {bad[0][1]}; ending the other ranks")
                return 1
            if all(c == 0 for c in codes):
                return 0
            if time.monotonic() >= deadline:
                alive = [r for r, c in enumerate(codes) if c is None]
                log(f"portbench: rank(s) {alive} still running after {limit_s:g} s; ending every rank")
                return 1
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p.poll() is None:
                _end(p)
        for p in procs:
            p.wait()


def assemble(records: List[dict], world: int) -> Tuple[Optional[dict], Optional[str]]:
    """(result, None) from the ranks' records, or (None, why) where the run
    has to fail: a record missing, two ranks on one card, or a forbidden
    module loaded in a rank. The device's `count` is the number of distinct
    cards the ranks ran on; `memory_peak_bytes` the fullest card's; `kind`
    and `power_limit_w` rank 0's card's, `power_limit_min_w` the least."""
    records = sorted(records, key=lambda r: r["rank"])
    if [r["rank"] for r in records] != list(range(world)):
        return None, f"records of ranks {[r['rank'] for r in records]}, want 0..{world - 1}"
    cards = [r["card"] for r in records]
    uuids = [c["uuid"] for c in cards]
    if len(set(uuids)) != len(uuids):
        return None, f"two ranks ran on one card: {uuids}"
    bad = sorted({m for r in records for m in r["forbidden"]})
    if bad:
        return None, f"loaded in a rank: {', '.join(bad)}"
    result = dict(records[0]["result"])
    powers = [c["power_limit_w"] for c in cards if c["power_limit_w"] is not None]
    device = {"platform": "gpu", "kind": cards[0]["kind"], "count": len(set(uuids)),
              "memory_peak_bytes": max(c["memory_peak_bytes"] for c in cards),
              "power_limit_w": cards[0]["power_limit_w"], "power_limit_min_w": min(powers) if powers else None}
    device.update({k: v for k, v in result["device"].items() if k in ("busy_s", "window_s")})
    result["device"] = device
    return result, None
