"""A torch.profiler Chrome trace, read for the per-layer metrics.

Every device operation (kernel, memcpy, memset) is tied to the host call
that launched it through its correlation id, and the launch to what the
host was inside at that moment on its thread: the spans the harness
records around the calls into each layer (`portbench.<layer>`), and the
innermost operator. Kernels launched inside an autograd engine function
are the backward pass's, whatever span the main thread is in.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "portbench."
BACKWARD_PREFIX = "autograd::engine::evaluate_function"
#: the names of communication kernels (NCCL's) start so
COMM_PREFIX = "nccl"
#: host calls that wait for the device
WAIT_WORDS = ("Synchronize", "EventQuery")

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersection(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def total(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def is_comm(op) -> bool:
    """A communication kernel: NCCL's, which the collectives launch."""
    return op.name.startswith(COMM_PREFIX)


class DeviceOp:
    __slots__ = ("name", "ts", "dur", "layer", "op")

    def __init__(self, name, ts, dur):
        self.name, self.ts, self.dur = name, ts, dur
        self.layer, self.op = "other", None


class Trace:
    """Times in microseconds, as the trace holds them.

    `window`: the span `portbench.window` (the traced stretch, which starts
    and ends with the device idle). `ops`: the device operations inside
    it, each with `layer` (the `portbench.` span it was launched in without
    the prefix, "backward", or "other") and `op` (the innermost host
    operator around its launch)."""

    def __init__(self, events: List[dict]):
        self.host: Dict[int, List[dict]] = defaultdict(list)  # tid -> cpu ops and spans
        launches: Dict[int, dict] = {}
        self.runtime: List[dict] = []
        device: List[dict] = []
        windows = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                device.append(ev)
            elif cat in LAUNCH_CATS:
                self.runtime.append(ev)
                corr = ev.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = ev
            elif cat in ("cpu_op", "user_annotation"):
                if cat == "user_annotation" and ev["name"] == SPAN_PREFIX + "window":
                    windows.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
                self.host[ev["tid"]].append(ev)
        if len(windows) != 1:
            raise ValueError(f"the trace holds {len(windows)} spans {SPAN_PREFIX}window, want 1")
        self.window: Interval = windows[0]
        by_name: Dict[str, List[float]] = defaultdict(list)
        for e in self.runtime:
            by_name[e["name"]].append(float(e["dur"]))
        self._median = {k: sorted(v)[len(v) // 2] for k, v in by_name.items()}
        self.ops: List[DeviceOp] = []
        queries: Dict[int, List[Tuple[float, DeviceOp]]] = defaultdict(list)
        lo, hi = self.window
        for ev in device:
            ts, dur = float(ev["ts"]), float(ev["dur"])
            if ts + dur <= lo or ts >= hi:
                continue
            op = DeviceOp(ev["name"], ts, dur)
            self.ops.append(op)
            launch = launches.get(ev.get("args", {}).get("correlation"))
            if launch is not None:
                queries[launch["tid"]].append((float(launch["ts"]), op))
        for tid, qs in queries.items():
            self._attribute(self.host.get(tid, []), qs)
        self.ops.sort(key=lambda o: o.ts)

    @staticmethod
    def _attribute(host: List[dict], queries: List[Tuple[float, DeviceOp]]) -> None:
        """Sweep the thread's host events in time order, keeping the stack of
        those open at each launch."""
        host = sorted(host, key=lambda e: (float(e["ts"]), -float(e["dur"])))
        stack: List[dict] = []
        i = 0
        for t, op in sorted(queries, key=lambda q: q[0]):
            while i < len(host) and float(host[i]["ts"]) <= t:
                stack.append(host[i])
                i += 1
            stack = [e for e in stack if float(e["ts"]) + float(e["dur"]) >= t]
            for e in reversed(stack):
                if e.get("cat") == "cpu_op" and op.op is None:
                    op.op = e["name"]
                if e["name"].startswith(BACKWARD_PREFIX):
                    op.layer = "backward"
                    break
                if e.get("cat") == "user_annotation" and e["name"].startswith(SPAN_PREFIX) \
                        and e["name"] not in (SPAN_PREFIX + "window", SPAN_PREFIX + "step"):
                    op.layer = e["name"][len(SPAN_PREFIX):]
                    break

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as fh:
            data = json.load(fh)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # ------------------------------------------------------------------ device
    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Interval]:
        """The union of the device operations' intervals, inside the window."""
        return clip(union((o.ts, o.ts + o.dur) for o in self.ops), *self.window)

    def busy_us(self) -> float:
        return total(self.busy())

    def layer_us(self, *layers: str) -> float:
        """Summed device time of the operations launched in `layers`."""
        return sum(o.dur for o in self.ops if o.layer in layers)

    def gaps(self) -> List[Tuple[Interval, Optional[DeviceOp]]]:
        """Each idle interval of the window, with the operation that ends it
        (None for the tail)."""
        out, t = [], self.window[0]
        starts = [o.ts for o in self.ops]
        for s, e in self.busy():
            if s > t:
                j = bisect.bisect_left(starts, s)
                out.append(((t, s), self.ops[j] if j < len(self.ops) else None))
            t = max(t, e)
        if t < self.window[1]:
            out.append(((t, self.window[1]), None))
        return out

    # ------------------------------------------------------------------ host
    def spans(self, name: str) -> List[dict]:
        """The host spans `portbench.<name>` inside the window."""
        lo, hi = self.window
        return sorted((e for evs in self.host.values() for e in evs
                       if e.get("cat") == "user_annotation" and e["name"] == SPAN_PREFIX + name
                       and lo <= float(e["ts"]) <= hi), key=lambda e: float(e["ts"]))

    def blocked_us(self, tid: int, lo: float, hi: float) -> float:
        """Time thread `tid` spent in [lo, hi) waiting on the device: in a
        call that waits, and the part of a launch beyond that call's median
        length (a launch blocks while the device's queue is full)."""
        out = 0.0
        for e in self.runtime:
            if e["tid"] != tid:
                continue
            s, d = float(e["ts"]), float(e["dur"])
            if s + d <= lo or s >= hi:
                continue
            d = min(s + d, hi) - max(s, lo)
            out += d if any(w in e["name"] for w in WAIT_WORDS) else max(0.0, d - self._median[e["name"]])
        return out

    def backward_threads(self) -> List[int]:
        return [tid for tid, evs in self.host.items() if any(e["name"].startswith(BACKWARD_PREFIX) for e in evs)]

    def busy_host_us(self, tid: int, lo: float, hi: float) -> float:
        """The union of the thread's host operators in [lo, hi)."""
        return total(clip(union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                                for e in self.host.get(tid, ()) if e.get("cat") == "cpu_op"), lo, hi))
