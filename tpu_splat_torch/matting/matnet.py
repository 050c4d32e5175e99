"""MatNet — a compact salient-subject matting net with bundled weights (the
port of tpu_splat/matting/matnet.py, as a torch nn.Module in NCHW).

A ~0.5M-parameter U-Net trained on procedurally generated composites (one
dominant centered subject over a distinct background), whose weights ship
with the package (`weights/matnet.npz`, float16, a byte-identical copy of the
reference's; the flat HWIO dict carries across with `matnet_state_dict`).
It serves the `u2net`/`u2net_human_seg` background-removal path when no
U2Net checkpoint is available (matting/remove.py) and the saliency weighting
of subject-aware blur scoring (ingest/blur.py).

The convolutions and group norms are library calls (the reference computes
them with lax.conv outside any Pallas kernel). Two details carry the
reference's numbers:
- SAME padding: a stride-2 3x3 layer pads (total // 2) before and the rest
  after, so an even input gets 0 before and 1 after (`Conv2d(padding=1)`
  would pad 1 on each side and shift every encoder level);
- resizes: `jax.image.resize(..., "bilinear")` antialiases when it
  downsamples, so every resize here that shrinks a dimension passes
  `antialias=True` (`resize_bilinear`).
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
            x = resize_bilinear(x, ref.shape[-2:])
            x = getattr(self, f"dec{i}")(torch.cat([x, ref], dim=1))
        return self.head(x)[:, 0]


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
