"""Real spherical harmonics, degrees 0..3 (the port of tpu_splat/gs/sh.py).

3DGS/gsplat coefficient ordering (m = -d..d per degree), so exported files
render identically in external viewers.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def eval_sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit directions -> (..., (degree+1)^2) basis values."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def sh_to_color(sh0: torch.Tensor, shN: torch.Tensor, dirs: torch.Tensor,
                degree: int) -> torch.Tensor:
    """sh0 (N, 3), shN (N, K, 3), dirs (N, 3) unit -> (N, 3) colors with the
    0.5 offset applied and clipped at 0, as in the 3DGS renderer."""
    basis = eval_sh_basis(degree, dirs)
    color = sh0 * basis[..., :1]
    b = basis.shape[-1] - 1
    if b > 0:
        # a broadcast sum, not a batched (1, b) x (b, 3) matmul per gaussian
        color = color + (basis[..., 1:, None] * shN[:, :b, :]).sum(dim=1)
    return torch.clamp_min(color + 0.5, 0.0)
