"""Host ms per step spent issuing the step: inside each `portbench.step`
span, the main thread's time less its time waiting on the device and its
time inside the backward call, plus the time the autograd engine's
threads spend in operators during that call less their waits. A wait is
a synchronizing call, or the part of a launch beyond that call's median
length (a launch blocks while the device's queue is full)."""


def read(r):
    t = r.trace
    if t is None:
        return None
    steps, fwd, opt = t.spans("step"), t.spans("forward"), t.spans("optimizer")
    if not steps or len(fwd) != len(steps) or len(opt) != len(steps):
        return None
    bw_threads = t.backward_threads()
    out = 0.0
    for st, f, o in zip(steps, fwd, opt):
        s, e = float(st["ts"]), float(st["ts"]) + float(st["dur"])
        b0, b1 = float(f["ts"]) + float(f["dur"]), float(o["ts"])
        main = st["tid"]
        out += (e - s) - (b1 - b0) - t.blocked_us(main, s, b0) - t.blocked_us(main, b1, e)
        out += sum(t.busy_host_us(tid, b0, b1) - t.blocked_us(tid, b0, b1) for tid in bw_threads if tid != main)
    return out / 1e3 / len(steps)
