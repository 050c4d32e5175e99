"""Equirectangular <-> cubemap <-> perspective projections (the port of
tpu_splat/spherical/projections.py), plain torch on the tensors' device.

Every projection is one bilinear gather over a batch of views: a stack of
rotations samples all its views at once, each from the ERP frame it names.
`torch.nn.functional.grid_sample` is not used: it has no horizontal wrap,
and the reference's sampler clamps y at h - 1.001.

Conventions: equirectangular images map longitude u in [-pi, pi) to x and
latitude v in [-pi/2, pi/2] to y (top = -pi/2). World frame: +z forward, +x
right, +y down (OpenCV-style), matching the rest of the pipeline.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

FACE_NAMES = ("front", "right", "back", "left", "up", "down")

# Rotation matrices taking face-local viewing directions to world directions.
# Face-local: +z looks out of the face, +x right, +y down.
_FACE_ROTS = {
    "front": np.eye(3),
    "right": np.array([[0, 0, 1.0], [0, 1, 0], [-1, 0, 0]]).T,
    "back": np.array([[-1.0, 0, 0], [0, 1, 0], [0, 0, -1]]).T,
    "left": np.array([[0, 0, -1.0], [0, 1, 0], [1, 0, 0]]).T,
    "up": np.array([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]]).T,
    "down": np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]]).T,
}


def _bilinear_wrap(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   frame: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bilinear sample with horizontal wrap (ERP) and vertical clamp.

    img (H, W, C), or (N, H, W, C) with `frame` (integer, broadcast against
    x) naming the image each sample reads. A tiny negative x wraps to exactly
    w in f32; like XLA's clamped gather, that reads column w - 1."""
    h, w = img.shape[-3:-1]
    flat = img.reshape(-1, img.shape[-1])
    x = torch.remainder(x, w)
    y = torch.clamp(y, 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.remainder(x0 + 1, w)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    base = 0 if frame is None else frame * (h * w)
    x0 = torch.clamp_max(x0, w - 1)

    def at(yi, xi):
        return flat[base + yi * w + xi]

    return (
        at(y0, x0) * (1 - fx) * (1 - fy)
        + at(y0, x1) * fx * (1 - fy)
        + at(y1, x0) * (1 - fx) * fy
        + at(y1, x1) * fx * fy
    )


def dirs_to_erp_xy(dirs: torch.Tensor, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit directions (..., 3) -> ERP pixel coords."""
    lon = torch.atan2(dirs[..., 0], dirs[..., 2])  # [-pi, pi], 0 = +z
    lat = torch.asin(torch.clamp(dirs[..., 1], -1.0, 1.0))  # [-pi/2, pi/2], + = down
    x = (lon / (2 * math.pi) + 0.5) * w - 0.5
    y = (lat / math.pi + 0.5) * h - 0.5
    return x, y


def rotation_yaw_pitch(yaw_deg: float, pitch_deg: float) -> np.ndarray:
    """World rotation for a view looking yaw degrees right and pitch degrees up."""
    ya = math.radians(yaw_deg)
    pa = math.radians(pitch_deg)
    Ry = np.array(
        [[math.cos(ya), 0, math.sin(ya)], [0, 1, 0], [-math.sin(ya), 0, math.cos(ya)]]
    )
    Rx = np.array(
        [[1, 0, 0], [0, math.cos(pa), math.sin(pa)], [0, -math.sin(pa), math.cos(pa)]]
    )
    return Ry @ Rx


def erp_to_perspective(
    erp: torch.Tensor,
    rots: torch.Tensor,
    out_h: int,
    out_w: int,
    fov_deg: float = 90.0,
    frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pinhole views of ERP images, all in one gather. rots (B, 3, 3):
    view-to-world. erp (H, W, C), or (N, H, W, C) with `frames` (B,) naming
    the image each view samples. Returns (B, out_h, out_w, C)."""
    dev = erp.device
    f = 0.5 * out_w / math.tan(math.radians(fov_deg) / 2)
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) - (out_w - 1) / 2) / f
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) - (out_h - 1) / 2) / f
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    local = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)
    local = local / torch.linalg.norm(local, dim=-1, keepdim=True)
    world = local @ rots.to(dev, torch.float32).transpose(-1, -2)[:, None]
    x, y = dirs_to_erp_xy(world, erp.shape[-3], erp.shape[-2])
    if frames is not None:
        frames = frames.to(dev)[:, None, None]
    return _bilinear_wrap(erp, x, y, frames)


def erp_to_cubemap(erp: torch.Tensor, face_size: int,
                   faces: Sequence[str] = FACE_NAMES) -> torch.Tensor:
    """ERP (H, W, C) -> (F, face_size, face_size, C) cube faces (90-degree views)."""
    rots = torch.as_tensor(np.stack([_FACE_ROTS[name] for name in faces]), dtype=torch.float32)
    return erp_to_perspective(erp, rots, face_size, face_size, 90.0)


def cubemap_to_erp(faces: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(6, S, S, C) faces (FACE_NAMES order) -> ERP (h, w, C)."""
    dev = faces.device
    s = faces.shape[1]
    lon = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2 * math.pi - math.pi
    lat = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * math.pi - math.pi / 2
    lat, lon = torch.meshgrid(lat, lon, indexing="ij")
    d = torch.stack(
        [torch.cos(lat) * torch.sin(lon), torch.sin(lat), torch.cos(lat) * torch.cos(lon)],
        dim=-1,
    )  # (h, w, 3)
    out = torch.zeros((h, w, faces.shape[-1]), dtype=faces.dtype, device=dev)
    best = torch.full((h, w), -math.inf, device=dev)
    f = (s - 1) / 2.0  # focal for 90 deg FOV at size s
    for i, name in enumerate(FACE_NAMES):
        R = torch.as_tensor(_FACE_ROTS[name], dtype=torch.float32, device=dev)
        local = d @ R  # world -> face-local: d @ R = R^T d
        z = local[..., 2]
        u = local[..., 0] / torch.clamp_min(z, 1e-9) * f + (s - 1) / 2
        v = local[..., 1] / torch.clamp_min(z, 1e-9) * f + (s - 1) / 2
        valid = (z > 0) & (u >= -0.5) & (u <= s - 0.5) & (v >= -0.5) & (v <= s - 0.5)
        sample = _bilinear_wrap(faces[i], torch.clamp(u, 0, s - 1.001),
                                torch.clamp(v, 0, s - 1.001))
        better = valid & (z > best)
        out = torch.where(better[..., None], sample, out)
        best = torch.where(better, z, best)
    return out
