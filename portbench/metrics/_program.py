"""The program's own spans in a torch.profiler trace, read for the
per-layer metrics of the training loop's host side.

The port records `aae.<name>` spans (`augmentedautoencoder_torch.training.
profiler.span`) on the thread that issues the work: `aae.train.step`
around each iteration and, inside it, `train.sample_batch`,
`train.forward` (holding `ops.phase_kernels` and `loss.bootstrap`),
`train.backward`, `train.optimizer`, `train.log` and `train.flush`. They
share the trace's clock with the runtime calls and the device's
operations (`_trace.Trace`), so a span's host time can leave out the
thread's waits on the device, and each sync and launch falls in the span
that made it. Only spans that start inside `portbench.window` count; every
reading is per `aae.train.step`. A trace without them (a program that
records none) gives None.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence

from ._trace import Interval, Trace, union

#: the program's span prefix, spelt here: the readers also run over programs that have no spans
PREFIX = "aae."
#: the spans inside a step that the batch, model and optimizer readers count
STEP_PARTS = ("train.sample_batch", "train.forward", "train.backward", "train.optimizer")


def bounds(ev: dict) -> Interval:
    return float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])


def spans(t: Trace, name: str) -> List[dict]:
    """The spans `aae.<name>` that start inside the window, in time order."""
    lo, hi = t.window
    return sorted((e for evs in t.host.values() for e in evs
                   if e.get("cat") == "user_annotation" and e["name"] == PREFIX + name
                   and lo <= float(e["ts"]) <= hi), key=lambda e: float(e["ts"]))


def is_sync(name: str) -> bool:
    """A host call that waits for the device: a synchronize of any kind, or a
    plain (blocking) `cudaMemcpy`. Polling (`cudaEventQuery`) is not one."""
    return "Synchronize" in name or name == "cudaMemcpy"


def is_launch(name: str) -> bool:
    """A host call that puts work on the device: a kernel launch (runtime or
    driver), an asynchronous copy or set."""
    return "Launch" in name or (name.endswith("Async") and ("Memcpy" in name or "Memset" in name))


def program_trace(r) -> Optional[Trace]:
    """The run's trace where it holds `aae.train.step` spans in the window,
    else None."""
    t = r.trace
    return t if t is not None and spans(t, "train.step") else None


def per_step(r, fn: Callable[[Trace, List[dict]], float]) -> Optional[float]:
    """`fn(trace, steps)` over the number of `aae.train.step` spans in the
    window, or None where the run has no trace or the trace none of them."""
    t = r.trace
    steps = [] if t is None else spans(t, "train.step")
    return fn(t, steps) / len(steps) if steps else None


def self_us(t: Trace, span: dict, minus: Sequence[dict] = ()) -> float:
    """Host us of `span` on its thread: its interval less the spans `minus`
    on that thread inside it, less the thread's time blocked on the device
    in what is left."""
    tid = span["tid"]
    lo, hi = bounds(span)
    cut = union((max(s, lo), min(e, hi)) for s, e in (bounds(m) for m in minus if m["tid"] == tid)
                if s < hi and e > lo)
    out, at = 0.0, lo
    for s, e in cut + [(hi, hi)]:
        if s > at:
            out += (s - at) - t.blocked_us(tid, at, s)
        at = max(at, e)
    return out


def host_ms(r, name: str, minus: Sequence[str] = ()) -> Optional[float]:
    """Host ms a step in the spans `aae.<name>`, by `self_us`, less the spans
    named in `minus` (without the prefix) inside them."""

    def total(t, steps):
        parts = [e for part in minus for e in spans(t, part)]
        return sum(self_us(t, s, parts) for s in spans(t, name)) / 1e3

    return per_step(r, total)


def backward_us(t: Trace, span: dict, engine: Iterable) -> float:
    """Host us of one `aae.train.backward`: the issuing thread's operators in
    it (the rest of its interval it waits for the autograd engine's threads
    `engine`, in no runtime call), and the engine's threads' operators in
    it, each less its waits on the device."""
    lo, hi = bounds(span)
    return sum(t.busy_host_us(tid, lo, hi) - t.blocked_us(tid, lo, hi) for tid in {span["tid"], *engine})


def runtime_in(t: Trace, lo: float, hi: float, pick: Callable[[str], bool], tids: Iterable = None) -> int:
    """The runtime calls that `pick` names and that start in [lo, hi), on
    the threads `tids` (any thread if None)."""
    tids = None if tids is None else set(tids)
    return sum(1 for e in t.runtime if lo <= float(e["ts"]) < hi and pick(e["name"])
               and (tids is None or e["tid"] in tids))
