"""Training losses for 3DGS: L1 + D-SSIM, scale and opacity regularisers, PSNR
(the port of tpu_splat/gs/losses.py)."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _blur_band_np(n: int, window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """(n, n) banded gaussian-blur matrix (zero-padded SAME semantics)."""
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = (g / g.sum()).astype(np.float32)
    band = np.zeros((n, n), np.float32)
    for o, w in zip(x, g):
        band += w * np.eye(n, k=int(o), dtype=np.float32)
    return band


@functools.lru_cache(maxsize=8)
def _blur_band(n: int, window_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_blur_band_np(n, window_size)).to(device)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Structural similarity over (H, W, C) images in [0, 1]; scalar mean.

    The separable 11-tap gaussian blur is two banded-matrix products, as in the
    reference, in full f32 (core/device.resolve_device switches TF32 off)."""
    c1, c2 = 0.01**2, 0.03**2
    h, w, c = img1.shape
    bw = _blur_band(w, window_size, img1.device)
    bh = _blur_band(h, window_size, img1.device)

    def conv(x):
        y = x.permute(2, 0, 1).reshape(c * h, w) @ bw
        y = y.reshape(c, h, w).transpose(1, 2).reshape(c * w, h) @ bh
        return y.reshape(c, w, h).permute(2, 1, 0)  # (H, W, C)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = conv(img1 * img1) - mu1_sq
    s2 = conv(img2 * img2) - mu2_sq
    s12 = conv(img1 * img2) - mu12
    num = (2 * mu12 + c1) * (2 * s12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    return torch.mean(num / den)


def image_loss(pred: torch.Tensor, gt: torch.Tensor, ssim_lambda: float = 0.2) -> torch.Tensor:
    """(1 - lambda) * L1 + lambda * (1 - SSIM), the standard 3DGS photometric loss."""
    l1 = torch.mean(torch.abs(pred - gt))
    return (1.0 - ssim_lambda) * l1 + ssim_lambda * (1.0 - ssim(pred, gt))


def scale_regularization(log_scales: torch.Tensor, alive: torch.Tensor,
                         max_ratio: float = 10.0) -> torch.Tensor:
    """mean over alive of max(max/min scale ratio, r) - r."""
    s = torch.exp(log_scales)
    ratio = s.amax(dim=-1) / torch.clamp_min(s.amin(dim=-1), 1e-8)
    pen = torch.clamp_min(ratio, max_ratio) - max_ratio
    denom = torch.clamp_min(alive.sum().to(pen.dtype), 1.0)
    return torch.sum(torch.where(alive, pen, torch.zeros_like(pen))) / denom


def opacity_entropy_loss(opacity_logits: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Pushes opacities toward 0/1 (the -w-light variant's alpha loss)."""
    a = torch.sigmoid(opacity_logits)
    ent = -(a * torch.log(a + 1e-8) + (1 - a) * torch.log(1 - a + 1e-8))
    denom = torch.clamp_min(alive.sum().to(ent.dtype), 1.0)
    return torch.sum(torch.where(alive, ent, torch.zeros_like(ent))) / denom


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
