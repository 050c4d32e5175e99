"""Image undistortion: SIMPLE_RADIAL / OPENCV -> pinhole (the port of
tpu_splat/sfm/undistort.py).

The colmap image_undistorter replacement. For each output (pinhole) pixel,
the forward distortion model gives its source location in the distorted
image, which is sampled bilinearly: one gather per frame, in torch on the
given device. The sampling grid depends only on the intrinsics, so a batch
computes it once. Points are undistorted on the host in numpy, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device


def distort_normalized(xn, yn, k1: float, k2: float = 0.0, p1: float = 0.0,
                       p2: float = 0.0):
    """Forward OPENCV distortion of normalized coords (k1, k2 radial; p1, p2
    tangential), for numpy arrays or tensors. SIMPLE_RADIAL is the k1-only
    special case."""
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return xd, yd


def _remap_grid(h: int, w: int, fx, fy, cx, cy, k1, k2, p1, p2, width: int, height: int,
                device: torch.device):
    """Source corners and bilinear weights of every output pixel: (y0, x0)
    int64 (height, width) and the fractional offsets (height, width, 1)."""
    f32 = torch.float32
    ys = (torch.arange(height, dtype=f32, device=device) - cy) / fy
    xs = (torch.arange(width, dtype=f32, device=device) - cx) / fx
    xn, yn = torch.meshgrid(xs, ys, indexing="xy")
    xd, yd = distort_normalized(xn, yn, k1, k2, p1, p2)
    sx = xd * fx + cx
    sy = yd * fy + cy
    sx = torch.clamp(sx, 0.0, w - 1.001)
    sy = torch.clamp(sy, 0.0, h - 1.001)
    x0 = torch.floor(sx).to(torch.int64)
    y0 = torch.floor(sy).to(torch.int64)
    fxp = (sx - x0.to(f32))[..., None]
    fyp = (sy - y0.to(f32))[..., None]
    return y0, x0, fxp, fyp


def _sample(image: torch.Tensor, grid) -> torch.Tensor:
    y0, x0, fxp, fyp = grid
    return (
        image[y0, x0] * (1 - fxp) * (1 - fyp)
        + image[y0, x0 + 1] * fxp * (1 - fyp)
        + image[y0 + 1, x0] * (1 - fxp) * fyp
        + image[y0 + 1, x0 + 1] * fxp * fyp
    )


def undistort_image(
    image,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    k1: float,
    k2: float = 0.0,
    p1: float = 0.0,
    p2: float = 0.0,
    width: int = 0,
    height: int = 0,
    device=None,
) -> torch.Tensor:
    """(H, W, C) distorted image -> undistorted pinhole image of the same size
    and intrinsics, a float32 tensor on `device` (CUDA unless the CPU is
    asked for)."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(image, np.float32), device=dev)
    h, w = img.shape[:2]
    grid = _remap_grid(h, w, fx, fy, cx, cy, k1, k2, p1, p2, width or w, height or h, dev)
    return _sample(img, grid)


def undistort_points(
    points2d: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    k1: float,
    k2: float = 0.0,
    p1: float = 0.0,
    p2: float = 0.0,
    iters: int = 8,
) -> np.ndarray:
    """Inverse distortion of pixel coordinates (fixed-point iteration: the
    standard undistortPoints scheme). Returns pinhole pixel coords."""
    xn = (points2d[:, 0] - cx) / fx
    yn = (points2d[:, 1] - cy) / fy
    xu, yu = xn.copy(), yn.copy()
    for _ in range(iters):
        xd, yd = distort_normalized(xu, yu, k1, k2, p1, p2)
        xu = xu - (np.asarray(xd) - xn)
        yu = yu - (np.asarray(yd) - yn)
    return np.stack([xu * fx + cx, yu * fy + cy], axis=1)


def undistort_batch(images: np.ndarray, fx, fy, cx, cy, k1, k2=0.0, p1=0.0,
                    p2=0.0, device=None) -> np.ndarray:
    """(N, H, W, C) frames -> undistorted frames (host numpy), each remapped
    on `device` through one shared sampling grid."""
    dev = resolve_device(device)
    h, w = images.shape[1:3]
    grid = _remap_grid(h, w, fx, fy, cx, cy, k1, k2, p1, p2, w, h, dev)
    out = np.empty(images.shape, np.float32)
    for i, img in enumerate(images):
        out[i] = _sample(torch.as_tensor(np.asarray(img, np.float32), device=dev),
                         grid).cpu().numpy()
    return out
