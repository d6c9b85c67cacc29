"""What decides `correct` in a training cell: the reference follows the
program's first steps from the same weights, pool and draws, and the
numbers that the cell's limits file names are compared, each against its
limit:

  loss_gap    the worst step of |loss - reference loss| / reference loss
  grad_gap    the first gradient as the optimizer got it (Adam's first
              moment after one step, over 1 - b1), by the worst leaf:
              | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|)
  update_gap  the parameters' change after the steps, the same way; a
              leaf whose reference gradient is under a thousandth of the
              median leaf's moves under Adam by round-off alone and is
              left out

A record is {"losses": [..], "grad": {leaf: tensor}, "p0": {..},
"pN": {..}}, from the program or from the reference.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from . import augment, model

NUMBERS = ("loss_gap", "grad_gap", "update_gap")
#: a leaf moved by round-off alone: reference gradient under this share of the median leaf's
STILL_LEAF = 1e-3


def reference_record(arch: model.Arch, chain: augment.Op, pool: dict, weights: Dict[str, torch.Tensor], seed: int,
                     batch: int, steps: int, lowp: Optional[Callable] = None) -> dict:
    """The reference's `steps` steps from `weights` (not changed), in float32
    with TF32 off, or through `lowp` (the control)."""
    device = next(iter(weights.values())).device
    n_train, n_bg = pool["train_x"].shape[0], pool["bg"].shape[0]
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    opt = model.Adam(params, arch.lr)
    losses: List[float] = []
    grad1 = None
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(steps):
            gen = torch.Generator(device=device).manual_seed(model.derive_seed(seed, i))
            draws = augment.draw_batch(gen, n_train, n_bg, batch, chain, (arch.h, arch.w, arch.c), device)
            x, y = augment.compose_batch(pool, draws, chain, torch.float32)
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            loss = model.bootstrapped_l2(model.forward(arch, leaves, x, lowp), y, arch.bootstrap)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            params = {k: v.detach() for k, v in leaves.items()}
            opt.step(params, grads)
            losses.append(loss.detach().item())
            if grad1 is None:
                grad1 = grads
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm
    return {"losses": losses, "grad": grad1, "p0": weights, "pN": params}


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _worst_leaf(got: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    med = sorted(ref[k] for k in leaves)[len(leaves) // 2]
    gaps = [abs(got[k] - ref[k]) / max(ref[k], med) for k in leaves]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def compare(rec: dict, ref: dict) -> Dict[str, float]:
    """The three numbers of `rec` against the reference's record `ref`."""
    if len(rec["losses"]) != len(ref["losses"]) or set(rec["grad"]) != set(ref["grad"]):
        return {k: math.inf for k in NUMBERS}
    loss = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], ref["losses"]))
    g, g_ref = _norms(rec["grad"]), _norms(ref["grad"])
    leaves = sorted(g_ref)
    med = sorted(g_ref.values())[len(g_ref) // 2]
    moving = [k for k in leaves if g_ref[k] >= STILL_LEAF * med]
    d = _norms({k: rec["pN"][k].double() - rec["p0"][k].double() for k in leaves})
    d_ref = _norms({k: ref["pN"][k].double() - ref["p0"][k].double() for k in leaves})
    out = {"loss_gap": loss if math.isfinite(loss) else math.inf,
           "grad_gap": _worst_leaf(g, g_ref, leaves),
           "update_gap": _worst_leaf(d, d_ref, moving)}
    return out


def details(rec: dict, ref: dict) -> dict:
    """For a look at what sets the numbers: each step's relative loss gap,
    the leaves with the largest gaps of gradient and update norms, and the
    leaves `compare` leaves out of the update."""
    g, g_ref = _norms(rec["grad"]), _norms(ref["grad"])
    d = _norms({k: rec["pN"][k].double() - rec["p0"][k].double() for k in g_ref})
    d_ref = _norms({k: ref["pN"][k].double() - ref["p0"][k].double() for k in g_ref})
    med_g, med_d = sorted(g_ref.values())[len(g_ref) // 2], sorted(d_ref.values())[len(d_ref) // 2]
    worst = lambda got, want, med: sorted(((abs(got[k] - want[k]) / max(want[k], med), k) for k in want),
                                          reverse=True)[:3]
    return {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(rec["losses"], ref["losses"])],
            "grad_worst": worst(g, g_ref, med_g), "update_worst": worst(d, d_ref, med_d),
            "still_leaves": sorted(k for k in g_ref if g_ref[k] < STILL_LEAF * med_g)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number that `limits` names is finite and at most its
    limit."""
    return bool(limits) and all(math.isfinite(numbers[k]) and numbers[k] <= v for k, v in limits.items())
