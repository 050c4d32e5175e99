"""SIFT-style feature extraction: DoG keypoints and oriented 128-d descriptors
(the port of tpu_splat/sfm/features.py).

- Gaussian/DoG pyramid: separable blurs written as the reference's tap loop
  (edge-padded, taps summed in the same order), batched over images.
- Keypoints: 3x3x3 extrema (max_pool3d, whose implicit padding is -inf as in
  the reference's reduce_window SAME), contrast and Hessian-ratio edge tests,
  a border margin, then a fixed top-K per octave and overall, so every image
  yields fixed-shape outputs with a validity mask. Top-K is a stable
  descending sort, which orders ties by lower index as lax.top_k does.
- Orientation (36-bin histogram) and descriptor (4x4 cells x 8 bins) read one
  row-flattened gradient table that holds every octave, each keypoint
  addressing its own octave through a row offset.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from tpu_splat_torch.core.device import resolve_device


@dataclass(frozen=True)
class FeatureConfig:
    max_features: int = 4096
    num_octaves: int = 4
    scales_per_octave: int = 3
    sigma0: float = 1.6
    contrast_threshold: float = 0.006
    edge_threshold: float = 10.0
    upsample_first: bool = False  # "enhanced" mode: 2x upsample before octave 0
    dsp: bool = False  # domain-size pooling: average descriptors over 3 scales


class Features(NamedTuple):
    """Per-image features; a batch carries a leading image axis on each."""

    xy: torch.Tensor  # (K, 2) pixel coordinates in the input image
    scale: torch.Tensor  # (K,) blur sigma at detection (input-image units)
    orientation: torch.Tensor  # (K,) radians
    response: torch.Tensor  # (K,) |DoG| response
    descriptor: torch.Tensor  # (K, 128) L2-normalised float32
    valid: torch.Tensor  # (K,) bool


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    radius = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of (..., H, W) images with edge padding, as the
    reference's tap loop (one weighted slice per tap, summed in tap order)."""
    k = _gaussian_kernel1d(sigma)
    r = len(k) // 2
    h, w = img.shape[-2:]
    rows = torch.arange(-r, h + r, device=img.device).clamp(0, h - 1)
    x = img[..., rows, :]
    out = torch.zeros_like(img)
    for i, wt in enumerate(k.tolist()):
        out = out + wt * x[..., i:i + h, :]
    cols = torch.arange(-r, w + r, device=img.device).clamp(0, w - 1)
    x = out[..., cols]
    out = torch.zeros_like(img)
    for i, wt in enumerate(k.tolist()):
        out = out + wt * x[..., i:i + w]
    return out


def _local_extrema(dog: torch.Tensor) -> torch.Tensor:
    """(B, S, H, W) -> bool mask of 26-neighbourhood extrema on interior scales."""
    mx = F.max_pool3d(dog[:, None], 3, stride=1, padding=1)[:, 0]
    mn = -F.max_pool3d(-dog[:, None], 3, stride=1, padding=1)[:, 0]
    mask = (dog >= mx) | (dog <= mn)
    mask[:, 0] = False
    mask[:, -1] = False
    return mask


def _edge_response_ok(dog: torch.Tensor, edge_threshold: float) -> torch.Tensor:
    """Reject edge-like extrema of (..., H, W) DoG levels by the Hessian
    trace/det ratio test."""
    def roll(x, s, d):
        return torch.roll(x, s, dims=d)

    dxx = roll(dog, -1, -1) - 2 * dog + roll(dog, 1, -1)
    dyy = roll(dog, -1, -2) - 2 * dog + roll(dog, 1, -2)
    dxy = 0.25 * (
        roll(roll(dog, -1, -2), -1, -1)
        - roll(roll(dog, -1, -2), 1, -1)
        - roll(roll(dog, 1, -2), -1, -1)
        + roll(roll(dog, 1, -2), 1, -1)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_threshold
    return (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: descending, ties by lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _bilinear3(stack, bidx, row_base, h, w, x, y):
    """Bilinear samples of a row-flattened (B, R, W0) gradient table at float
    coords (..., S), clamped to each keypoint's level (h, w); `row_base` is
    the level's first row and `bidx` the image of each keypoint."""
    x = torch.minimum(torch.clamp_min(x, 0.0), w - 1.001)
    y = torch.minimum(torch.clamp_min(y, 0.0), h - 1.001)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.long()
    r0 = row_base + y0f.long()
    v00 = stack[bidx, r0, x0]
    v01 = stack[bidx, r0, x0 + 1]
    v10 = stack[bidx, r0 + 1, x0]
    v11 = stack[bidx, r0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _bin_sum(bins: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """Histogram (..., n) of weights w (..., S) in bins (..., S), as a masked
    sum over S: a fixed summation order, where scatter_add_'s CUDA atomics
    would round differently from run to run."""
    ar = torch.arange(n, device=bins.device)
    return torch.where(bins[..., None] == ar, w[..., None], 0.0).sum(-2)


def _keypoint_orientation(gxs, gys, bidx, row_base, h, w, x, y, sigma):
    """Dominant gradient orientation (..., ) in a gaussian-weighted window
    (36 bins, circular smoothing, parabolic refinement)."""
    grid = torch.linspace(-1.0, 1.0, 9, device=x.device)
    radius = (3.0 * sigma)[..., None]
    gr = grid * radius  # (..., 9)
    ox = gr[..., None, :].expand(gr.shape[:-1] + (9, 9)).flatten(-2)
    oy = gr[..., :, None].expand(gr.shape[:-1] + (9, 9)).flatten(-2)
    ex = lambda a: a[..., None]  # noqa: E731
    mag_x = _bilinear3(gxs, ex(bidx), ex(row_base), ex(h), ex(w), ex(x) + ox, ex(y) + oy)
    mag_y = _bilinear3(gys, ex(bidx), ex(row_base), ex(h), ex(w), ex(x) + ox, ex(y) + oy)
    mag = torch.sqrt(mag_x**2 + mag_y**2)
    ang = torch.atan2(mag_y, mag_x)
    wgt = torch.exp(-(ox**2 + oy**2) / ex(2 * (1.5 * sigma) ** 2))
    bins = torch.remainder(torch.floor((ang + math.pi) / (2 * math.pi) * 36).long(), 36)
    hist = _bin_sum(bins, mag * wgt, 36)
    hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    b = torch.argmax(hist, dim=-1, keepdim=True)
    left = torch.gather(hist, -1, (b - 1) % 36)[..., 0]
    right = torch.gather(hist, -1, (b + 1) % 36)[..., 0]
    center = torch.gather(hist, -1, b)[..., 0]
    denom = left - 2 * center + right
    off = torch.where(denom.abs() > 1e-6, 0.5 * (left - right) / denom,
                      torch.zeros_like(denom))
    return (b[..., 0].to(x.dtype) + off + 0.5) / 36.0 * 2 * math.pi - math.pi


def _descriptor(gxs, gys, bidx, row_base, h, w, x, y, sigma, theta):
    """128-d SIFT descriptors (..., 128): 4x4 spatial cells x 8 orientation
    bins from a rotated 16x16 sample grid."""
    d, n_ori, samples = 4, 8, 16
    lin = (torch.arange(samples, device=x.device) - samples / 2 + 0.5) / samples * d
    u = lin[None, :].expand(samples, samples).reshape(-1)  # (256,)
    v = lin[:, None].expand(samples, samples).reshape(-1)
    ex = lambda a: a[..., None]  # noqa: E731
    cos_t, sin_t = ex(torch.cos(theta)), ex(torch.sin(theta))
    hist_width = ex(3.0 * sigma)
    sx = ex(x) + (cos_t * u - sin_t * v) * hist_width
    sy = ex(y) + (sin_t * u + cos_t * v) * hist_width
    args = (ex(bidx), ex(row_base), ex(h), ex(w), sx, sy)
    gxv = _bilinear3(gxs, *args)
    gyv = _bilinear3(gys, *args)
    mag = torch.sqrt(gxv**2 + gyv**2)
    ang = torch.atan2(gyv, gxv) - ex(theta)
    wgt = torch.exp(-(u**2 + v**2) / (2 * (d / 2) ** 2))
    w_mag = mag * wgt

    # Soft assignment to 4x4 spatial cells (bilinear) and 8 orientation bins
    # (linear). A sample's cells and spatial weights depend only on its grid
    # position, so they form one fixed (256, 16) matrix; the orientation part
    # is a per-keypoint (256, 8) histogram, and the descriptor is their
    # product (the reference scatter-adds the 8 corners one by one).
    ub = u + d / 2 - 0.5
    vb = v + d / 2 - 0.5
    ob = torch.remainder(ang, 2 * math.pi) / (2 * math.pi) * n_ori
    u0, v0, o0 = torch.floor(ub), torch.floor(vb), torch.floor(ob)
    fu, fv, fo = ub - u0, vb - v0, ob - o0
    u0, v0, o0 = u0.long(), v0.long(), o0.long()

    cells = torch.arange(d * d, device=x.device)
    spatial = 0.0
    for du, wu in ((0, 1 - fu), (1, fu)):
        uu = u0 + du
        u_ok = (uu >= 0) & (uu < d)
        for dv, wv in ((0, 1 - fv), (1, fv)):
            vv = v0 + dv
            ok = u_ok & (vv >= 0) & (vv < d)
            cell = vv.clamp(0, d - 1) * d + uu.clamp(0, d - 1)
            spatial = spatial + torch.where((cell[:, None] == cells) & ok[:, None],
                                            (wu * wv)[:, None], 0.0)
    orient = 0.0
    for do, wo in ((0, 1 - fo), (1, fo)):
        orient = orient + torch.where(
            torch.remainder(o0 + do, n_ori)[..., None] == torch.arange(n_ori, device=x.device),
            (w_mag * wo)[..., None], 0.0)
    desc = (orient.mT @ spatial).mT.flatten(-2)  # (..., 16 cells x 8 bins)
    vec = desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), 1e-8)
    vec = torch.clamp_max(vec, 0.2)
    return vec / torch.clamp_min(torch.linalg.vector_norm(vec, dim=-1, keepdim=True), 1e-8)


def extract_features(images: torch.Tensor, cfg: FeatureConfig) -> Features:
    """Extract up to cfg.max_features SIFT features from each grayscale image
    of (B, H, W) (or one (H, W) image) in [0, 1], on the images' device.
    Outputs are fixed-shape with a validity mask."""
    if images.dim() == 2:
        return Features(*(a[0] for a in extract_features(images[None], cfg)))
    img = images.to(torch.float32)
    bsz, height, width = img.shape
    dev = img.device
    if cfg.upsample_first:
        img = F.interpolate(img[:, None], size=(height * 2, width * 2), mode="bilinear",
                            align_corners=False)[:, 0]
        base_scale = 0.5
    else:
        base_scale = 1.0

    s = cfg.scales_per_octave
    k = 2.0 ** (1.0 / s)
    sigmas = [cfg.sigma0 * (k**i) for i in range(s + 3)]
    sigmas_t = torch.tensor(sigmas, dtype=torch.float32, device=dev)

    # octaves that will run (downsampling floors at 32 px)
    hh, ww = img.shape[-2:]
    n_oct = 0
    for _ in range(cfg.num_octaves):
        n_oct += 1
        hh, ww = (hh + 1) // 2, (ww + 1) // 2
        if min(hh, ww) < 32:
            break

    kk = cfg.max_features
    all_resp, all_x, all_y, all_sig, all_oct, all_sidx = [], [], [], [], [], []
    gauss_stacks = []
    border_margin = 8
    cur = _blur(img, cfg.sigma0)
    for octave in range(n_oct):
        h, w = cur.shape[-2:]
        stack = [cur]
        for i in range(1, s + 3):
            inc = math.sqrt(max(sigmas[i] ** 2 - sigmas[i - 1] ** 2, 1e-6))
            stack.append(_blur(stack[-1], inc))
        gauss = torch.stack(stack, dim=1)  # (B, S+3, h, w)
        gauss_stacks.append(gauss)
        dog = gauss[:, 1:] - gauss[:, :-1]  # (B, S+2, h, w)

        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        border = ((yy >= border_margin) & (yy < h - border_margin)
                  & (xx >= border_margin) & (xx < w - border_margin))
        mask = (_local_extrema(dog) & (dog.abs() > cfg.contrast_threshold)
                & _edge_response_ok(dog, cfg.edge_threshold) & border)
        resp = torch.where(mask, dog.abs(), torch.zeros_like(dog)).reshape(bsz, -1)
        top_resp, top_idx = _top_k(resp, min(kk, resp.shape[1]))
        scale_i = top_idx // (h * w)
        rem = top_idx % (h * w)
        py = rem // w
        px = rem % w
        octave_scale = base_scale * (2.0**octave)
        all_resp.append(top_resp)
        all_x.append((px.to(torch.float32) + 0.5) * octave_scale - 0.5)
        all_y.append((py.to(torch.float32) + 0.5) * octave_scale - 0.5)
        all_sig.append(sigmas_t[scale_i + 1] * octave_scale)
        all_oct.append(torch.full_like(scale_i, octave))
        all_sidx.append(scale_i + 1)
        cur = stack[s][..., ::2, ::2]

    # one row-flattened gradient table for every octave, narrower octaves
    # right-padded to octave 0's width (never sampled: x is clamped per level)
    w0 = gauss_stacks[0].shape[-1]
    gx_rows, gy_rows, row_offs, oct_h, oct_w = [], [], [], [], []
    off = 0
    for gauss in gauss_stacks:
        gx = (torch.roll(gauss, -1, 3) - torch.roll(gauss, 1, 3)) * 0.5
        gy = (torch.roll(gauss, -1, 2) - torch.roll(gauss, 1, 2)) * 0.5
        oh, ow = gauss.shape[-2:]
        gx_rows.append(F.pad(gx.reshape(bsz, -1, ow), (0, w0 - ow)))
        gy_rows.append(F.pad(gy.reshape(bsz, -1, ow), (0, w0 - ow)))
        row_offs.append(off)
        oct_h.append(oh)
        oct_w.append(ow)
        off += gauss.shape[1] * oh
    gxs = torch.cat(gx_rows, dim=1)
    gys = torch.cat(gy_rows, dim=1)
    del gauss_stacks, gx_rows, gy_rows

    resp = torch.cat(all_resp, dim=1)
    top_resp, sel = _top_k(resp, kk)
    valid = top_resp > 0

    def pick(parts):
        return torch.gather(torch.cat(parts, dim=1), 1, sel)

    xs, ys, sig = pick(all_x), pick(all_y), pick(all_sig)
    octs, sidx = pick(all_oct), pick(all_sidx)

    as_t = lambda v: torch.tensor(v, device=dev)[octs]  # noqa: E731
    octave_scale = base_scale * torch.exp2(octs.to(torch.float32))
    oh_k, ow_k = as_t(oct_h), as_t(oct_w)
    row_base = as_t(row_offs) + sidx * oh_k
    bidx = torch.arange(bsz, device=dev)[:, None].expand_as(octs)
    lx = (xs + 0.5) / octave_scale - 0.5
    ly = (ys + 0.5) / octave_scale - 0.5
    lsig = sig / octave_scale
    geo = (gxs, gys, bidx, row_base, oh_k, ow_k, lx, ly)
    theta = _keypoint_orientation(*geo, lsig)
    if cfg.dsp:
        desc = sum(_descriptor(*geo, lsig * f, theta) for f in (0.75, 1.0, 1.5)) / 3.0
        desc = desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=-1, keepdim=True),
                                      1e-8)
    else:
        desc = _descriptor(*geo, lsig, theta)
    desc = torch.where(valid[..., None], desc, torch.zeros_like(desc))
    return Features(xy=torch.stack([xs, ys], dim=-1), scale=sig, orientation=theta,
                    response=top_resp, descriptor=desc, valid=valid)


def extract_features_batch(images: Union[np.ndarray, torch.Tensor], cfg: FeatureConfig,
                           chunk: int = 8,
                           device: Optional[Union[str, torch.device]] = None) -> Features:
    """Extraction over (N, H, W) grayscale images, `chunk` images per pass
    (bounding the pyramid's memory), on `device` (CUDA unless the CPU is asked
    for). Returns Features with a leading image axis."""
    dev = resolve_device(device)
    images = torch.as_tensor(images)
    outs = [extract_features(images[i:i + chunk].to(dev, torch.float32), cfg)
            for i in range(0, images.shape[0], chunk)]
    return Features(*(torch.cat(parts) for parts in zip(*outs)))


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(H, W[, 3]) -> (H, W) luminance (batched over leading dims of RGB
    input)."""
    if img.dim() == 2:
        return img
    return img @ torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
