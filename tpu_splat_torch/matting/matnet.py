"""MatNet — a compact salient-subject matting net with bundled weights (the
port of tpu_splat/matting/matnet.py, as a torch nn.Module in NCHW).

A ~0.5M-parameter U-Net trained on procedurally generated composites (one
dominant centered subject over a distinct background), whose weights ship
with the package (`weights/matnet.npz`, float16, a byte-identical copy of the
reference's; the flat HWIO dict carries across with `matnet_state_dict`).
It serves the `u2net`/`u2net_human_seg` background-removal path when no
U2Net checkpoint is available (matting/remove.py) and the saliency weighting
of subject-aware blur scoring (ingest/blur.py). `init_params`, `save_params`
and `matnet_params` carry the reference's training surface: matting/train.py
trains the net from the reference's seeded init and writes weights that
either package loads.

The convolutions and group norms are library calls (the reference computes
them with lax.conv outside any Pallas kernel). Two details carry the
reference's numbers:
- SAME padding: a stride-2 3x3 layer pads (total // 2) before and the rest
  after, so an even input gets 0 before and 1 after (`Conv2d(padding=1)`
  would pad 1 on each side and shift every encoder level);
- resizes: `jax.image.resize(..., "bilinear")` antialiases when it
  downsamples, so every resize here that shrinks a dimension passes
  `antialias=True` (`resize_bilinear`). In training the decoder's
  upsampling is the product with jax.image.resize's own weight matrices
  (`_upsample`): its backward is two more products, a fixed order of sums,
  where F.interpolate's backward on CUDA accumulates with atomics and would
  make training differ from run to run.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_splat_torch.core.device import resolve_device

_RES = 256  # inference resolution (square); outputs are resized back
_CH = (16, 32, 64, 96)  # encoder levels at full/2/4/8 resolution
_BATCH = 8  # frames per forward pass


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) to `size`, as jax.image.resize does
    it: half-pixel centres, and antialiased where a dimension shrinks."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    shrinks = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrinks)


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of jax.image.resize's bilinear (triangle)
    kernel when n_out >= n_in: half-pixel centres, each row normalised, so
    the edge rows clamp to the border pixel."""
    sample = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[:, None] - np.arange(n_in)[None, :]))
    return w / w.sum(axis=1, keepdims=True)


def _upsample(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsampling of (N, C, h, w) to `size`: F.interpolate when no
    gradient will flow back (inference; faster on the card), else two
    matrix products, whose backward runs in a fixed order."""
    if tuple(x.shape[-2:]) == tuple(size) or not x.requires_grad:
        return resize_bilinear(x, size)
    rows = torch.from_numpy(_resize_matrix(x.shape[-2], size[0])).to(x.device, x.dtype)
    cols = torch.from_numpy(_resize_matrix(x.shape[-1], size[1]).T.copy()).to(x.device, x.dtype)
    return rows @ x @ cols


def _same_pad(x: torch.Tensor, k: int, stride: int, dilation: int) -> torch.Tensor:
    """lax's SAME padding: output ceil(n / stride), the odd pixel after."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad lists the last dimension first
        out = -(-n // stride)
        total = max((out - 1) * stride + dilation * (k - 1) + 1 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _Block(nn.Module):
    """3x3 conv (SAME) -> GroupNorm(min(8, c)) -> ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, dilation=dilation)
        self.norm = nn.GroupNorm(min(8, cout), cout, eps=1e-5)

    def forward(self, x):
        x = self.conv(_same_pad(x, 3, self.stride, self.dilation))
        return F.relu(self.norm(x))


class MatNet(nn.Module):
    """x: (N, 3, H, W) in [0, 1] -> logits (N, H, W)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, c in enumerate(_CH):
            setattr(self, f"enc{i}a", _Block(cin, c, stride=1 if i == 0 else 2))
            setattr(self, f"enc{i}b", _Block(c, c))
            cin = c
        # dilated context block at the bottom (rates 2, 4)
        self.ctx1 = _Block(_CH[-1], _CH[-1], dilation=2)
        self.ctx2 = _Block(_CH[-1], _CH[-1], dilation=4)
        for i in range(len(_CH) - 2, -1, -1):
            setattr(self, f"dec{i}", _Block(_CH[i + 1] + _CH[i], _CH[i]))
        self.head = nn.Conv2d(_CH[0], 1, 1)

    def forward(self, x):
        x = x - 0.5
        skips = []
        for i in range(len(_CH)):
            x = getattr(self, f"enc{i}b")(getattr(self, f"enc{i}a")(x))
            skips.append(x)
        x = self.ctx2(self.ctx1(x))
        for i in range(len(_CH) - 2, -1, -1):
            ref = skips[i]
            x = _upsample(x, ref.shape[-2:])
            x = getattr(self, f"dec{i}")(torch.cat([x, ref], dim=1))
        return self.head(x)[:, 0]


def init_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """The reference's He-initialised flat parameter dict (HWIO), from the
    same numpy draws in the same order."""
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}

    def conv(name, cin, cout, k=3):
        fan = k * k * cin
        p[f"{name}.w"] = (rng.standard_normal((k, k, cin, cout))
                          * np.sqrt(2.0 / fan)).astype(np.float32)
        p[f"{name}.b"] = np.zeros((cout,), np.float32)

    def norm(name, c):
        p[f"{name}.s"] = np.ones((c,), np.float32)
        p[f"{name}.o"] = np.zeros((c,), np.float32)

    cin = 3
    for i, c in enumerate(_CH):
        conv(f"enc{i}a", cin, c)
        norm(f"enc{i}a.n", c)
        conv(f"enc{i}b", c, c)
        norm(f"enc{i}b.n", c)
        cin = c
    # dilated context block at the bottom (rates 2, 4)
    conv("ctx1", _CH[-1], _CH[-1])
    norm("ctx1.n", _CH[-1])
    conv("ctx2", _CH[-1], _CH[-1])
    norm("ctx2.n", _CH[-1])
    for i in range(len(_CH) - 2, -1, -1):
        conv(f"dec{i}", _CH[i + 1] + _CH[i], _CH[i])
        norm(f"dec{i}.n", _CH[i])
    conv("head", _CH[0], 1, k=1)
    return p


def matnet_state_dict(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The reference's flat parameter dict (`enc0a.w` HWIO, `enc0a.b`,
    `enc0a.n.s`, `enc0a.n.o`, ..., `head.w`) as MatNet's state dict (OIHW)."""
    sd = {}
    for key, v in params.items():
        name, leaf = key.rsplit(".", 1)
        t = torch.as_tensor(np.asarray(v, np.float32))
        if leaf == "w":
            sd[("head" if name == "head" else f"{name}.conv") + ".weight"] = \
                t.permute(3, 2, 0, 1).contiguous()
        elif leaf == "b":
            sd[("head" if name == "head" else f"{name}.conv") + ".bias"] = t
        else:  # "<block>.n.s" / "<block>.n.o": the block's GroupNorm
            sd[f"{name[:-2]}.norm." + {"s": "weight", "o": "bias"}[leaf]] = t
    return sd


def matnet_params(net) -> Dict[str, np.ndarray]:
    """The inverse of `matnet_state_dict`: a MatNet (or a mapping with its
    state-dict keys, such as its gradients) as the reference's flat HWIO
    dict of float32 numpy arrays."""
    sd = net.state_dict() if isinstance(net, nn.Module) else net
    params = {}
    for key, t in sd.items():
        owner, leaf = key.rsplit(".", 1)  # "<block>.conv", "<block>.norm" or "head"
        block, part = owner.rsplit(".", 1) if "." in owner else (owner, "conv")
        a = t.detach().cpu().numpy().astype(np.float32)
        if part == "norm":
            params[f"{block}.n." + {"weight": "s", "bias": "o"}[leaf]] = a
        elif leaf == "weight":
            params[f"{block}.w"] = a.transpose(2, 3, 1, 0)
        else:
            params[f"{block}.b"] = a
    return params


def save_params(params: Dict[str, np.ndarray], path: str) -> None:
    """The reference's weight file: float16 arrays in a compressed npz under
    the flat keys. A net cached from `path` is dropped, so the next
    `matnet_saliency` call reads the new weights."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v).astype(np.float16)
                                 for k, v in params.items()})
    for key in [k for k in _CACHE if k[0] == path]:
        del _CACHE[key]


def load_params(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k].astype(np.float32) for k in z.files}


def bundled_weights_path() -> Optional[str]:
    cand = os.environ.get("TPU_SPLAT_MATNET_WEIGHTS")
    if cand and os.path.exists(cand):
        return cand
    here = os.path.join(os.path.dirname(__file__), "weights", "matnet.npz")
    return here if os.path.exists(here) else None


def load_matnet(path: str, device) -> MatNet:
    """MatNet in eval mode on `device`, with the weights at `path` (npz)."""
    net = MatNet()
    net.load_state_dict(matnet_state_dict(load_params(path)))
    return net.eval().to(device)


_CACHE: Dict[Tuple[str, str], MatNet] = {}


def matnet_saliency(images: np.ndarray, weights_path: Optional[str] = None,
                    device=None) -> Optional[np.ndarray]:
    """images (N, H, W, 3) float32 [0,1] -> saliency (N, H, W) in [0,1], or
    None when no weights are found (callers fall back to classical
    saliency). Runs on `device` (CUDA unless the CPU is asked for), 8 frames
    a pass: upload, resize to 256x256, net, sigmoid, resize back."""
    dev = resolve_device(device)
    path = weights_path or bundled_weights_path()
    if path is None:
        return None
    key = (path, str(dev))
    if key not in _CACHE:
        _CACHE[key] = load_matnet(path, dev)
    net = _CACHE[key]
    n, h, w, _ = images.shape
    out = np.empty((n, h, w), np.float32)
    with torch.no_grad():
        for i in range(0, n, _BATCH):
            x = torch.as_tensor(np.ascontiguousarray(images[i:i + _BATCH], np.float32),
                                device=dev).permute(0, 3, 1, 2)
            sal = torch.sigmoid(net(resize_bilinear(x, (_RES, _RES))))
            sal = resize_bilinear(sal[:, None], (h, w))[:, 0]
            out[i:i + _BATCH] = torch.clamp(sal, 0.0, 1.0).cpu().numpy()
    return out
