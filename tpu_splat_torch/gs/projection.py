"""EWA projection of 3D gaussians to screen space (the port of
tpu_splat/gs/projection.py).

The camera-frame covariance C = (W R_q S)(W R_q S)^T is formed with
broadcast multiplies and sums over (N, 3, 3, 3) rather than batched 3x3
matmuls: cuBLAS runs 512K 3x3 products as tiny GEMMs, several times slower
than the elementwise form (the reference scalarises the same algebra for the
TPU's registers).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Low-pass filter added to the 2D covariance diagonal (0.3 px screen dilation).
EPS2D = 0.3


class Projected(NamedTuple):
    """Per-gaussian screen-space quantities for one camera."""

    means2d: torch.Tensor  # (N, 2) pixel coordinates
    conics: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    depths: torch.Tensor  # (N,) camera-space z
    radii: torch.Tensor  # (N,) screen extent in pixels (0 = culled)
    compensations: torch.Tensor  # (N,) AA opacity scaling (1 when not antialiased)


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz quaternions (not necessarily unit) -> (N, 3, 3) rotations."""
    q = quats / torch.clamp_min(torch.linalg.norm(quats, dim=-1, keepdim=True), 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    ).reshape(q.shape[:-1] + (3, 3))


def project_gaussians(
    means: torch.Tensor,
    log_scales: torch.Tensor,
    quats: torch.Tensor,
    viewmat: torch.Tensor,
    fx,
    fy,
    cx,
    cy,
    width: int,
    height: int,
    near: float = 0.01,
    far: float = 1e10,
    antialiased: bool = False,
    opacities: Optional[torch.Tensor] = None,
) -> Projected:
    """Project N gaussians through one camera (OpenCV convention, w2c 4x4).

    fx, fy, cx, cy may be Python floats or 0-d tensors."""
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    p_cam = means @ R.T + t
    x, y, z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]
    zs = torch.clamp_min(z, 1e-6)

    # tangent-plane clamp keeps the EWA Jacobian bounded off-frustum
    lim_x = 1.3 * (0.5 * width / fx)
    lim_y = 1.3 * (0.5 * height / fy)
    tx = torch.clamp(x / zs, -lim_x, lim_x) * zs
    ty = torch.clamp(y / zs, -lim_y, lim_y) * zs

    # M = W R_q S and C = M M^T, as broadcast products (see the module note)
    M = (R[None, :, :, None] * quat_to_rotmat(quats)[:, None, :, :]).sum(dim=2)
    M = M * torch.exp(log_scales)[:, None, :]
    C = (M[:, :, None, :] * M[:, None, :, :]).sum(dim=-1)
    C00, C01, C02 = C[:, 0, 0], C[:, 0, 1], C[:, 0, 2]
    C11, C12, C22 = C[:, 1, 1], C[:, 1, 2], C[:, 2, 2]

    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    f1 = fx * inv_z
    f2 = fy * inv_z
    j13 = -fx * tx * inv_z2
    j23 = -fy * ty * inv_z2
    # cov2d = J C J^T for J = [[f1, 0, j13], [0, f2, j23]]
    a = f1 * f1 * C00 + 2 * f1 * j13 * C02 + j13 * j13 * C22
    c = f2 * f2 * C11 + 2 * f2 * j23 * C12 + j23 * j23 * C22
    b = f1 * f2 * C01 + f1 * j23 * C02 + f2 * j13 * C12 + j13 * j23 * C22

    det_raw = a * c - b * b
    a = a + EPS2D
    c = c + EPS2D
    det = torch.clamp_min(a * c - b * b, 1e-12)
    # mip-splatting opacity compensation sqrt(det_raw / det_blurred)
    comp = torch.sqrt(torch.clamp_min(det_raw, 0.0) / det)

    inv_det = 1.0 / det
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    means2d = torch.stack([fx * x * inv_z + cx, fy * y * inv_z + cy], dim=-1)

    # opacity-aware extent: alpha >= 1/255 holds within sqrt(2 ln(255 op))
    # sigma, capped at the classic 3 sigma
    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    if opacities is not None:
        k = torch.sqrt(torch.clamp_min(
            2.0 * torch.log(torch.clamp_min(opacities * 255.0, 1e-6)), 0.0))
        k = torch.clamp_max(k, 3.0)
        visible_op = opacities * 255.0 > 1.0
    else:
        k = 3.0
        visible_op = torch.ones_like(z, dtype=torch.bool)
    radius = torch.ceil(k * torch.sqrt(torch.clamp_min(lambda1, 0.0)))

    inside = (
        (z > near)
        & (z < far)
        & visible_op
        & (radius > 0)
        & (means2d[:, 0] + radius > 0)
        & (means2d[:, 0] - radius < width)
        & (means2d[:, 1] + radius > 0)
        & (means2d[:, 1] - radius < height)
    )
    radii = torch.where(inside, radius, torch.zeros_like(radius)).detach()
    if not antialiased:
        comp = torch.ones_like(comp)
    return Projected(means2d=means2d, conics=conic, depths=z, radii=radii,
                     compensations=comp)
