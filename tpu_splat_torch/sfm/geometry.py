"""SO(3) helpers the trainer's camera-pose deltas need (the port's copy of
`hat` and `exp_so3` from tpu_splat/sfm/geometry.py)."""

from __future__ import annotations

import torch


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zeros = torch.zeros_like(x)
    return torch.stack(
        [zeros, -z, y, z, zeros, -x, -y, x, zeros], dim=-1
    ).reshape(v.shape[:-1] + (3, 3))


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation.

    Sinc form (no w/|w| normalisation) so the gradient is finite at w = 0;
    the 1e-12 keeps theta >= 1e-6, where sin(theta)/theta == 1 in f32."""
    n2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    t2 = n2 + 1e-12
    theta = torch.sqrt(t2)
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / t2
    k = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    return eye + a * k + b * (k @ k)
