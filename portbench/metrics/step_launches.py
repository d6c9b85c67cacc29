"""Runtime calls per step that put work on the device (kernel launches,
asynchronous copies and sets): on the training thread inside
`aae.train.step`, and on the autograd engine's threads inside
`aae.train.backward`."""

from ._program import bounds, is_launch, per_step, runtime_in, spans


def _count(t, steps):
    engine = [tid for tid in t.backward_threads() if tid not in {s["tid"] for s in steps}]
    main = sum(runtime_in(t, *bounds(s), is_launch, [s["tid"]]) for s in steps)
    return main + sum(runtime_in(t, *bounds(b), is_launch, engine) for b in spans(t, "train.backward"))


def read(r):
    return per_step(r, _count)
