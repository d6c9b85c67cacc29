"""The decoder bank's share of a traced multi-path step.

The program records the span `aae.ops.decoder_bank` around the bank's
forward (`models/decoder.DecoderBank`). Its backward runs later on the
autograd engine's threads, outside any span; torch.profiler ties each
backward node (`autograd::engine::evaluate_function: <node>`) to the
forward operator that made it by the forward's sequence number. So the
bank's work is what the launches inside the span start, and what the
launches inside the backward nodes whose sequence numbers the span's
operators hold start: kernels, copies and sets, tied to their launch by
correlation id. Its device time is the union of those operations'
intervals inside the window, so that two of its operations that run at
once, on two streams, count once. `BankTrace` reads that once, beside
`_trace.Trace`'s attribution; a trace without the span reads nothing
(None).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List

from ._program import bounds, is_launch
from ._trace import BACKWARD_PREFIX, DEVICE_CATS, LAUNCH_CATS, Trace, clip, total, union

#: the program's span around the bank's forward, spelt here: the readers also run over programs without it
BANK_SPAN = "aae.ops.decoder_bank"
SEQ = "Sequence number"


def _within(regions):
    """A test of whether an event starts inside one of `regions`, (tid,
    start, end) intervals that do not overlap on one thread."""
    by = defaultdict(list)
    for tid, s, e in regions:
        by[tid].append((s, e))
    starts = {tid: sorted(v) for tid, v in by.items()}
    keys = {tid: [s for s, _ in v] for tid, v in starts.items()}

    def test(ev: dict) -> bool:
        tid = ev["tid"]
        if tid not in starts:
            return False
        ts = float(ev["ts"])
        i = bisect.bisect_right(keys[tid], ts) - 1
        return i >= 0 and ts < starts[tid][i][1]

    return test


class BankTrace(Trace):
    """A `Trace` that also holds the bank's device us (`bank_us`, the union
    of its operations' intervals) and its launches (`bank_launches`) over
    the window, or None for both where the window holds no bank span."""

    def __init__(self, events: List[dict]):
        super().__init__(events)
        self.bank_us = self.bank_launches = None
        lo, hi = self.window
        xs = [e for e in events if e.get("ph") == "X"]
        spans = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == BANK_SPAN
                 and lo <= float(e["ts"]) <= hi]
        if not spans:
            return
        in_span = _within([(e["tid"],) + bounds(e) for e in spans])
        seqs = {e["args"][SEQ] for e in xs if e.get("cat") == "cpu_op" and SEQ in e.get("args", {})
                and not e["name"].startswith(BACKWARD_PREFIX) and in_span(e)}
        nodes = [e for e in xs if e.get("cat") == "cpu_op" and e["name"].startswith(BACKWARD_PREFIX)
                 and e.get("args", {}).get(SEQ) in seqs and lo <= float(e["ts"]) <= hi]
        in_backward = _within([(e["tid"],) + bounds(e) for e in nodes])
        launches = [e for e in xs if e.get("cat") in LAUNCH_CATS and is_launch(e["name"])
                    and (in_span(e) or in_backward(e))]
        corr = {e.get("args", {}).get("correlation") for e in launches}
        self.bank_launches = len(launches)
        self.bank_us = total(clip(union(bounds(e) for e in xs if e.get("cat") in DEVICE_CATS
                                        and e.get("args", {}).get("correlation") in corr), lo, hi))
