"""Full splat rendering: SH color decode, EWA projection, tile rasterizer
(the port of tpu_splat/gs/render.py)."""

from __future__ import annotations

from typing import Optional

import torch

from tpu_splat_torch.core.device import as_tensor, resolve_device
from tpu_splat_torch.core.types import Cameras, GaussianCloud, to_numpy
from tpu_splat_torch.gs.projection import project_gaussians
from tpu_splat_torch.gs.rasterize import RasterOutput, rasterize
from tpu_splat_torch.gs.sh import sh_to_color


def render_view(
    means: torch.Tensor,
    log_scales: torch.Tensor,
    quats: torch.Tensor,
    opacity_logits: torch.Tensor,
    sh0: torch.Tensor,
    shN: torch.Tensor,
    viewmat: torch.Tensor,
    fx,
    fy,
    cx,
    cy,
    width: int,
    height: int,
    sh_degree: int = 3,
    background: Optional[torch.Tensor] = None,
    antialiased: bool = False,
    tile_size: int = 16,
    max_per_tile: int = 512,
    means2d_dummy: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    device=None,
) -> RasterOutput:
    """Render one view. `means2d_dummy` (N, 2 zeros) lets callers take
    screen-space gradients for densification; `alive` masks padded slots."""
    dev = resolve_device(device)
    means, log_scales, quats, opacity_logits, sh0, shN, viewmat = (
        as_tensor(x, dev) for x in
        (means, log_scales, quats, opacity_logits, sh0, shN, viewmat))
    op_sig = torch.sigmoid(opacity_logits)
    # AA compensation only shrinks opacity, so the sigmoid bounds the cutoff
    proj = project_gaussians(
        means, log_scales, quats, viewmat, fx, fy, cx, cy, width, height,
        antialiased=antialiased, opacities=op_sig,
    )
    means2d = proj.means2d
    if means2d_dummy is not None:
        means2d = means2d + means2d_dummy

    cam_pos = -viewmat[:3, :3].T @ viewmat[:3, 3]
    dirs = means - cam_pos
    dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-12)
    colors = sh_to_color(sh0, shN, dirs, sh_degree)

    opacities = op_sig * proj.compensations
    radii = proj.radii
    if alive is not None:
        radii = torch.where(as_tensor(alive, dev, torch.bool), radii, torch.zeros_like(radii))

    return rasterize(
        means2d, proj.conics, colors, opacities, proj.depths, radii,
        width=width, height=height, background=background, tile_size=tile_size,
        max_per_tile=max_per_tile, device=dev,
    )


def render_cloud(
    cloud: GaussianCloud,
    cameras: Cameras,
    cam_index: int = 0,
    sh_degree: Optional[int] = None,
    background: Optional[torch.Tensor] = None,
    max_per_tile: int = 512,
    device=None,
) -> RasterOutput:
    """Render a GaussianCloud through one camera of a Cameras batch."""
    viewmat = cameras.worldtocams[cam_index]
    return render_view(
        cloud.means, cloud.scales, cloud.quats, cloud.opacities, cloud.sh0, cloud.shN,
        viewmat,
        float(to_numpy(cameras.fx)[cam_index]),
        float(to_numpy(cameras.fy)[cam_index]),
        float(to_numpy(cameras.cx)[cam_index]),
        float(to_numpy(cameras.cy)[cam_index]),
        cameras.width, cameras.height,
        sh_degree=cloud.sh_degree if sh_degree is None else sh_degree,
        background=background, antialiased=cloud.antialiased,
        max_per_tile=max_per_tile, device=device,
    )
