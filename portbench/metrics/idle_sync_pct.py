"""The share of the traced window in idle gaps of the device inside which a
host call that waits for the device (`_program.is_sync`, on any thread)
returned: the card ran dry because the host waited on it, then the host
refilled its queue from empty. The window's tail, which nothing refills,
is left out. At most `device_idle_pct`."""

import bisect

from ._program import bounds, is_sync, program_trace


def read(r):
    t = program_trace(r)
    if t is None or not t.ops or t.window_us <= 0:
        return None
    returns = sorted(bounds(e)[1] for e in t.runtime if is_sync(e["name"]))
    idle = sum(e - s for (s, e), nxt in t.gaps()
               if nxt is not None and bisect.bisect_right(returns, e) > bisect.bisect_left(returns, s))
    return 100.0 * idle / t.window_us
