"""Train MatNet on procedural composites (the port of scripts/train_matnet.py).

    python -m tpu_splat_torch.matting.train [--steps 3000] [--batch 16] \\
        [--lr 3e-4] [--seed 0] [--eval-only] [--out PATH] [--device cpu]

Trains from `matnet.init_params(seed)` on `synthdata.make_batch` batches
(numpy, on the host, from default_rng(seed + 1)) with the script's loss (a
stable BCE plus half of one minus the soft IoU) and its optimizer: Adam with
the bias correction folded into the learning rate, eps outside it, and a
cosine decay over the run. torch.optim.Adam adds eps to the corrected second
moment, so it is another optimizer; the update is written out here. Writes
the float16 npz that both packages load (by default over the port's bundled
weights, as the script writes the reference's) and prints the held-out IoU
on the matting test's composite capture and on a fresh generator batch.

No hand-written kernel lies on this path: the reference computes MatNet with
lax.conv and jax.image.resize outside any Pallas kernel, and the port's
convolutions and group norms are cuDNN and PyTorch calls in f32
(core/device.resolve_device turns TF32 off). Each step runs with cuDNN's
deterministic algorithms, and the decoder upsamples by matrix products
(matnet._upsample), so a run repeats bit for bit on the card.

Runs on CUDA unless `--device cpu` (or `device="cpu"`) is given, and raises
without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpu_splat_torch.core.device import as_tensor, resolve_device
from tpu_splat_torch.matting import matnet
from tpu_splat_torch.matting.synthdata import make_batch

B1, B2, EPS = 0.9, 0.999, 1e-8


# the CLI's default --out, as the script's is the reference's bundled file
_BUNDLED = os.path.join(os.path.dirname(os.path.abspath(matnet.__file__)), "weights",
                        "matnet.npz")


def matnet_loss(logits: torch.Tensor, masks: torch.Tensor):
    """(loss, soft IoU) of logits (N, H, W) against masks (N, H, W): the
    stable BCE plus 0.5 * (1 - soft IoU), the union floored at 1."""
    bce = torch.mean(torch.clamp(logits, min=0) - logits * masks
                     + torch.log1p(torch.exp(-torch.abs(logits))))
    p = torch.sigmoid(logits)
    inter = torch.sum(p * masks, dim=(1, 2))
    union = torch.sum(p + masks - p * masks, dim=(1, 2))
    soft_iou = torch.mean(inter / torch.clamp(union, min=1.0))
    return bce + 0.5 * (1.0 - soft_iou), soft_iou


@dataclass
class MatNetTrainState:
    """The net and the optimizer's moments, by the net's parameter names."""

    net: matnet.MatNet
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def init_train_state(seed: int = 0, device=None) -> MatNetTrainState:
    dev = resolve_device(device)
    net = matnet.MatNet()
    net.load_state_dict(matnet.matnet_state_dict(matnet.init_params(seed)))
    net = net.train().to(dev)
    zeros = {k: torch.zeros_like(p) for k, p in net.named_parameters()}
    return MatNetTrainState(net, zeros, {k: z.clone() for k, z in zeros.items()})


def adam_lr(lr: float, t: int, steps: int) -> float:
    """The script's step size at step t (from 1): Adam's bias correction
    times a cosine decay to 0 at `steps`."""
    lr_t = lr * math.sqrt(1 - B2 ** t) / (1 - B1 ** t)
    return lr_t * 0.5 * (1 + math.cos(math.pi * min(t / steps, 1.0)))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (its weight-gradient ones may
    otherwise accumulate in any order), restored on exit."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def train_step(state: MatNetTrainState, imgs, masks, t: int, lr: float, steps: int):
    """One step at step number t (from 1) of a `steps`-step run on imgs (N,
    H, W, 3) in [0, 1] and masks (N, H, W). Updates `state` in place (the
    step's gradients stay on the parameters until the next step) and returns
    (loss, soft IoU) as tensors on the device (nothing syncs)."""
    dev = next(state.net.parameters()).device
    x = as_tensor(imgs, dev).permute(0, 3, 1, 2).contiguous()
    y = as_tensor(masks, dev)
    with deterministic_cudnn():
        loss, soft_iou = matnet_loss(state.net(x), y)
        state.net.zero_grad(set_to_none=True)
        loss.backward()
    lr_t = adam_lr(lr, t, steps)
    with torch.no_grad():
        for name, p in state.net.named_parameters():
            g = p.grad
            m = B1 * state.m[name] + (1 - B1) * g
            v = B2 * state.v[name] + (1 - B2) * g * g
            p.sub_(lr_t * m / (torch.sqrt(v) + EPS))
            state.m[name], state.v[name] = m, v
    return loss.detach(), soft_iou.detach()


def train_matnet(steps: int = 3000, batch: int = 16, lr: float = 3e-4, seed: int = 0,
                 out: Optional[str] = None, device=None,
                 log_fn: Callable[[str], None] = print) -> dict:
    """The script's run: `steps` steps of `batch` 256x256 composites from
    init_params(seed), logging at step 1 and every 100th. Writes the
    weights to `out` when it is given. Returns the per-step losses, the
    host seconds spent making batches, the card's ms per step (CUDA events
    around each step's upload and update; None on the CPU), the wall
    seconds and the trained flat parameter dict."""
    dev = resolve_device(device)
    state = init_train_state(seed, dev)
    rng = np.random.default_rng(seed + 1)
    cuda = dev.type == "cuda"
    losses, events = [], []
    data_s = 0.0
    t0 = time.time()
    for i in range(1, steps + 1):
        td = time.perf_counter()
        imgs, masks = make_batch(rng, batch)
        data_s += time.perf_counter() - td
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        loss, iou = train_step(state, imgs, masks, i, lr, steps)
        if cuda:
            ev[1].record()
            events.append(ev)
        losses.append(loss)
        if i % 100 == 0 or i == 1:
            log_fn(f"step {i:5d}  loss {float(loss):.4f}  soft-iou "
                   f"{float(iou):.3f}  {time.time() - t0:.0f}s")
    if cuda:
        torch.cuda.synchronize(dev)
    params = matnet.matnet_params(state.net)
    if out:
        matnet.save_params(params, out)
        log_fn(f"saved {out} ({os.path.getsize(out) / 1e6:.2f} MB)")
    return {
        "losses": torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32),
        "data_s": data_s,
        "step_ms": [a.elapsed_time(b) for a, b in events] if cuda else None,
        "seconds": time.time() - t0,
        "params": params,
    }


def evaluate(path: str, device=None, log_fn: Callable[[str], None] = print) -> dict:
    """Held-out check of the weights at `path`: the matting test's composite
    capture (never trained on) and a fresh generator batch of 24. Returns
    the mean and least IoU of each at 0.5."""
    from tpu_splat_torch.testing import composite_scene, mask_iou

    dev = resolve_device(device)
    res = {}
    for tag, label, (imgs, gt) in (
            ("scene", "held-out bench-scene", composite_scene()),
            ("fresh", "generator fresh-batch", make_batch(np.random.default_rng(12345), 24))):
        sal = matnet.matnet_saliency(imgs, path, device=dev)
        ious = [mask_iou(sal[i], gt[i]) for i in range(len(imgs))]
        res[tag] = (float(np.mean(ious)), float(np.min(ious)))
        log_fn(f"{label} IoU: {res[tag][0]:.3f} (min {res[tag][1]:.3f})")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--out", default=_BUNDLED)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(f"device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""),
          flush=True)
    log = lambda s: print(s, flush=True)  # noqa: E731
    if not args.eval_only:
        train_matnet(args.steps, args.batch, args.lr, args.seed, args.out, dev, log)
    evaluate(args.out, dev, log)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
