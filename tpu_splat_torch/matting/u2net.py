"""U2Net salient-object matting (the port of tpu_splat/matting/u2net.py).

The U^2-Net architecture (RSU-7..RSU-4F encoder/decoder with side outputs)
as torch modules whose state-dict keys are the standard PyTorch U2Net
checkpoint's (`stage1.rebnconvin.conv_s1.weight`, `...bn_s1.running_mean`,
`side1.weight`, `outconv.bias`), so a user's u2net.pth / u2net_human_seg.pth
loads with `load_state_dict(strict=True)`. No weights are bundled. BatchNorm
runs in eval mode; pooling is max_pool2d(2, 2, ceil_mode=True), the same as
flax's SAME padding there; upsampling is a bilinear resize to the skip's size.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_splat_torch.matting.matnet import resize_bilinear

_RES = 320  # U2Net's input resolution
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class REBNCONV(nn.Module):
    def __init__(self, in_ch: int = 3, out_ch: int = 3, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _down(x):
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _up_to(x, ref):
    return resize_bilinear(x, ref.shape[-2:])


class RSU(nn.Module):
    """Residual U-block of a given height (RSU-7 has height 7)."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch, 1)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, 1)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", REBNCONV(mid_ch, mid_ch, 1))
        setattr(self, f"rebnconv{height}", REBNCONV(mid_ch, mid_ch, 2))
        for i in range(height - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", REBNCONV(2 * mid_ch, mid_ch, 1))
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch, 1)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        # encoder
        feats: List[torch.Tensor] = []
        hx = hxin
        for i in range(1, self.height):
            hx = getattr(self, f"rebnconv{i}")(hx)
            feats.append(hx)
            if i < self.height - 1:
                hx = _down(hx)
        hx = getattr(self, f"rebnconv{self.height}")(hx)
        # decoder
        for i in range(self.height - 1, 0, -1):
            skip = feats[i - 1]
            hx = _up_to(hx, skip)
            hx = getattr(self, f"rebnconv{i}d")(torch.cat([hx, skip], dim=1))
        return hx + hxin


class RSU4F(nn.Module):
    """Dilated (no-pooling) residual U-block."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch, 1)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, 1)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNCONV(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNCONV(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch, 1)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        h3d = self.rebnconv3d(torch.cat([h4, h3], 1))
        h2d = self.rebnconv2d(torch.cat([h3d, h2], 1))
        h1d = self.rebnconv1d(torch.cat([h2d, h1], 1))
        return h1d + hxin


# (height or "4F", in, mid, out) per stage: encoder stage1-6, decoder stage5d-1d
_CFGS = {
    "full": (
        [(7, 3, 32, 64), (6, 64, 32, 128), (5, 128, 64, 256), (4, 256, 128, 512),
         ("4F", 512, 256, 512), ("4F", 512, 256, 512)],
        [("4F", 1024, 256, 512), (4, 1024, 128, 256), (5, 512, 64, 128), (6, 256, 32, 64),
         (7, 128, 16, 64)],
    ),
    "small": (
        [(7, 3, 16, 64), (6, 64, 16, 64), (5, 64, 16, 64), (4, 64, 16, 64),
         ("4F", 64, 16, 64), ("4F", 64, 16, 64)],
        [("4F", 128, 16, 64), (4, 128, 16, 64), (5, 128, 16, 64), (6, 128, 16, 64),
         (7, 128, 16, 64)],
    ),
}


def _stage(height, in_ch, mid_ch, out_ch) -> nn.Module:
    if height == "4F":
        return RSU4F(in_ch, mid_ch, out_ch)
    return RSU(height, in_ch, mid_ch, out_ch)


class U2Net(nn.Module):
    """Full U^2-Net (cfg='full') or U2NetP (cfg='small'). x: (N, 3, H, W) ->
    [fused, side1..side6] sigmoid maps, each (N, 1, H, W)."""

    def __init__(self, cfg: str = "full"):
        super().__init__()
        enc, dec = _CFGS[cfg]
        for i, spec in enumerate(enc, start=1):
            setattr(self, f"stage{i}", _stage(*spec))
        for i, spec in zip(range(5, 0, -1), dec):
            setattr(self, f"stage{i}d", _stage(*spec))
        # side i reads decoder stage i (side6: encoder stage 6)
        side_ch = [dec[4][3], dec[3][3], dec[2][3], dec[1][3], dec[0][3], enc[5][3]]
        for i, c in enumerate(side_ch, start=1):
            setattr(self, f"side{i}", nn.Conv2d(c, 1, 3, padding=1))
        self.outconv = nn.Conv2d(6, 1, 1)

    def forward(self, x):
        hs = []
        hx = x
        for i in range(1, 7):
            hx = getattr(self, f"stage{i}")(hx)
            hs.append(hx)
            if i < 6:
                hx = _down(hx)
        d = hs[5]
        feats = {6: hs[5]}
        for i in range(5, 0, -1):
            skip = hs[i - 1]
            d = getattr(self, f"stage{i}d")(torch.cat([_up_to(d, skip), skip], dim=1))
            feats[i] = d
        outs = [_up_to(getattr(self, f"side{i}")(feats[i]), x) for i in range(1, 7)]
        fused = self.outconv(torch.cat(outs, dim=1))
        return [torch.sigmoid(o) for o in [fused] + outs]


def u2net_state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax U2Net variables ({"params", "batch_stats"}) as the standard torch
    state dict (kernels HWIO -> OIHW; BatchNorm scale/bias/mean/var ->
    weight/bias/running_mean/running_var, num_batches_tracked 0)."""
    sd: Dict[str, torch.Tensor] = {}
    leaf_names = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, path + [k])
                continue
            arr = np.asarray(v, np.float32)
            if k == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))
            sd[".".join(path + [leaf_names[k]])] = torch.tensor(arr)
            if k == "var":
                sd[".".join(path + ["num_batches_tracked"])] = torch.tensor(0)

    walk(variables["params"], [])
    walk(variables["batch_stats"], [])
    return sd


def load_u2net(path: str, device, cfg: str = "full") -> U2Net:
    """U2Net in eval mode on `device` from a standard PyTorch checkpoint (a
    state dict; loaded with weights_only, so no pickled code runs)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    net = U2Net(cfg)
    net.load_state_dict(sd, strict=True)
    return net.eval().to(device)


def u2net_apply(net: U2Net, images: torch.Tensor) -> torch.Tensor:
    """images (N, H, W, 3) in [0,1], on the net's device -> saliency masks
    (N, H, W) in [0,1].

    Applies the standard U2Net preprocessing (per-image max-normalize +
    ImageNet mean/std) at 320x320 and resizes the fused output back."""
    n, h, w, _ = images.shape
    x = resize_bilinear(images.permute(0, 3, 1, 2), (_RES, _RES))
    x = x / torch.clamp_min(x.amax(dim=(1, 2, 3), keepdim=True), 1e-6)
    mean = torch.tensor(_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(_STD, device=x.device)[:, None, None]
    fused = net((x - mean) / std)[0][:, 0]
    mn = fused.amin(dim=(1, 2), keepdim=True)
    mx = fused.amax(dim=(1, 2), keepdim=True)
    fused = (fused - mn) / torch.clamp_min(mx - mn, 1e-6)
    return resize_bilinear(fused[:, None], (h, w))[:, 0]
