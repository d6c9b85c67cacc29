"""Where the card's and the CPU's gradients of one f32 train step part.

Trains the template's full-width AAE for 100 Adam steps on smooth
synthetic batches, then computes the gradients of 4 batches of 8 (phase
7's parity batch) in f32 and in f64, on the card and on the CPU, from the same
state, and prints, against the CPU's f64 step (and the card's f32 step
against the CPU's): the loss's relative error,
the pixels whose membership in the bootstrap's top-k set differs, the
pre-activations whose sign differs (per conv), and per tensor max |dgrad| /
max |grad| and |dgrad|_2 / |grad|_2. f64 runs the port's forward with its
f32 casts taken out (encoder flatten, decoder input and heads, the k-th
value), so that the same code runs in f64 throughout.

    python scripts/train_grad_precision.py

Needs a CUDA card; `--device cpu --cfg <small cfg>` rehearses it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import types

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from augmentedautoencoder_torch import factory  # noqa: E402
from augmentedautoencoder_torch.config import load_train_config  # noqa: E402
from augmentedautoencoder_torch.models import losses  # noqa: E402
from augmentedautoencoder_torch.models.decoder import resize_conv  # noqa: E402
from augmentedautoencoder_torch.training import make_optimizer  # noqa: E402

TEMPLATE = os.path.join(REPO, "augmentedautoencoder_torch", "cfg_templates", "train_template.cfg")
STEPS, TRIALS, BATCH = 100, 4, 8


def encoder_forward(self, x):
    """Encoder.forward (no BN, no VAE) in the input's dtype."""
    x = x.permute(0, 3, 1, 2)
    for i, conv in enumerate(self.convs):
        x = F.relu(conv(F.pad(x, self._pads[i])))
    return self.latent(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


def decoder_forward(self, z):
    """Decoder.forward (no BN, no mask head) in the input's dtype."""
    h0, w0, c0 = self.first
    x = F.relu(self.dense(z)).reshape(-1, h0, w0, c0).permute(0, 3, 1, 2)
    for i, conv in enumerate(self.convs):
        x = F.relu(resize_conv(conv, x, self.layer_dims[i + 1]))
    return torch.sigmoid(resize_conv(self.reconstruction, x, self.output_hw)).permute(0, 2, 3, 1)


def batch(cfg, b, gen, device):
    """Smooth images with blocky empty regions as targets; inputs with noise."""
    low = torch.rand((b, 3, 8, 8), generator=gen, device=device)
    y = F.interpolate(low, size=(cfg.h, cfg.w), mode="bilinear", align_corners=False)
    keep = (torch.rand((b, 1, 16, 16), generator=gen, device=device) > 0.5).float()
    y = y * F.interpolate(keep, size=(cfg.h, cfg.w), mode="nearest")
    x = (y + 0.1 * torch.rand(y.shape, generator=gen, device=device)).clamp(0, 1)
    return x.permute(0, 2, 3, 1).contiguous(), y.permute(0, 2, 3, 1).contiguous()


def step_grads(cfg, state, device, dtype, x, y):
    """Loss, gradients, conv pre-activations and per-pixel errors of one
    train step from `state` (all on the CPU, f64)."""
    model = factory.build_train_model(cfg, device)
    model.load_state_dict(state)
    model.to(dtype).train()
    if dtype != torch.float32:
        model.encoder.forward = types.MethodType(encoder_forward, model.encoder)
        model.decoder.forward = types.MethodType(decoder_forward, model.decoder)
    acts = {}
    convs = [(f"enc{i}", c) for i, c in enumerate(model.encoder.convs)]
    convs += [(f"dec{i}", c) for i, c in enumerate(model.decoder.convs)]
    hooks = [c.register_forward_hook(lambda mod, inp, out, n=n: acts.__setitem__(n, out.detach().cpu().double()))
             for n, c in convs]
    out = model(x.to(device, dtype), y.to(device, dtype), train=True)
    model.zero_grad()
    out.total_loss.backward()
    for h in hooks:
        h.remove()
    err = ((out.reconstruction.detach() - y.to(device, dtype)) ** 2).reshape(x.shape[0], -1).double().cpu()
    grads = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()}
    return out.total_loss.item(), grads, acts, err


def top_set(err, ratio):
    k = err.shape[1] // ratio
    return err >= torch.kthvalue(err, err.shape[1] - k + 1, dim=1, keepdim=True).values


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--cfg", default=TEMPLATE)
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = args.device
    if dev == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}", flush=True)
    cfg = load_train_config(args.cfg)
    # the f64 step selects with torch.kthvalue too; kth_largest insists on f32
    losses.kth_largest = lambda err, k: torch.kthvalue(err, err.shape[1] - k + 1, dim=1, keepdim=True).values
    gen = torch.Generator(device=dev).manual_seed(0)
    model = factory.build_train_model(cfg, dev, seed=3)
    optim = make_optimizer(model, cfg)
    model.train()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        x, y = batch(cfg, cfg.batch_size, gen, dev)
        out = model(x, y, train=True)
        optim.zero_grad()
        out.total_loss.backward()
        optim.step()
    print(f"{STEPS} steps of batch {cfg.batch_size} in {time.perf_counter() - t0:.1f} s, "
          f"loss {out.total_loss.item():.6f}", flush=True)
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    arms = {"card f32": (dev, torch.float32), "cpu f32": ("cpu", torch.float32),
            "card f64": (dev, torch.float64), "cpu f64": ("cpu", torch.float64)}
    for trial in range(TRIALS):
        x, y = (t.cpu() for t in batch(cfg, BATCH, gen, dev))
        res = {name: step_grads(cfg, state, d, dt, x, y) for name, (d, dt) in arms.items()}
        for name, ref_name in (("card f32", "cpu f64"), ("cpu f32", "cpu f64"), ("card f64", "cpu f64"),
                               ("card f32", "cpu f32")):
            (loss, grads, acts, err), ref = res[name], res[ref_name]
            flips = {n: int(((acts[n] > 0) != (ref[2][n] > 0)).sum()) for n in ref[2]}
            rel = {n: float((grads[n] - ref[1][n]).abs().max() / ref[1][n].abs().max()) for n in ref[1]}
            l2 = {n: float((grads[n] - ref[1][n]).norm() / ref[1][n].norm()) for n in ref[1]}
            worst = max(rel, key=rel.get)
            differ = int((top_set(err, cfg.bootstrap_ratio) != top_set(ref[3], cfg.bootstrap_ratio)).sum())
            print(f"trial {trial} {name} vs {ref_name}: loss rel {abs(loss - ref[0]) / ref[0]:.2e}; top-k set "
                  f"differs in {differ} pixels; sign flips {flips}; max |dgrad| / max |grad| {rel[worst]:.2e} "
                  f"({worst}); |dgrad|_2 / |grad|_2 up to {max(l2.values()):.2e}", flush=True)


if __name__ == "__main__":
    main()
