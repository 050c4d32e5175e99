"""Per-camera intrinsics refinement against a converged map (the port of
tpu_splat/sfm/intrinsics.py).

With poses and points fixed, each camera's focal scale and principal-point
shift is an independent 3-parameter weighted least squares over its own
observations, solved in closed form for every camera at once (deterministic segment
sums, a batched 3x3 solve), with a few IRLS Huber rounds.

Model per observation o of camera c (normalised image coordinates):
    obs_o  ~=  s_c * proj_o + d_c          (s_c ~ f'_c / f_c,  d_c = pp shift)
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from tpu_splat_torch.sfm.ba import BAProblem, Segments


def refine_intrinsics_per_camera(problem: BAProblem, iters: int = 3, huber_delta: float = 0.01,
                                 max_focal_step: float = 0.15, max_pp_shift: float = 0.05
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (focal_scale (C,), pp_shift (C, 2), rms_after).

    focal_scale multiplies each camera's fx/fy; pp_shift is in normalised
    units (multiply by fx for pixels). Cameras with fewer than 12
    observations keep identity. Steps are trust-clamped: |log s| <=
    max_focal_step, |shift| <= max_pp_shift."""
    C = problem.cam_rotmats.shape[0]
    cam = problem.obs_cam
    pc = (torch.einsum("oij,oj->oi", problem.cam_rotmats[cam], problem.points[problem.obs_pt])
          + problem.cam_trans[cam])
    z = torch.clamp_min(pc[:, 2], 1e-6)
    proj = pc[:, :2] / z[:, None]
    valid = problem.obs_valid & (pc[:, 2] > 1e-6)
    obs = problem.obs_uv
    dtype, dev = proj.dtype, proj.device

    seg = Segments(cam, C)

    s = torch.ones((C,), dtype=dtype, device=dev)
    d = torch.zeros((C, 2), dtype=dtype, device=dev)
    zc = torch.zeros((C,), dtype=dtype, device=dev)
    eye = 1e-9 * torch.eye(3, dtype=dtype, device=dev)
    for _ in range(iters):
        model = proj * s[cam][:, None] + d[cam]
        r = torch.linalg.vector_norm(model - obs, dim=-1)
        w = torch.where(r <= huber_delta, torch.ones_like(r),
                        huber_delta / torch.clamp_min(r, 1e-12))
        w = w * valid.to(dtype)
        px, py = proj[:, 0], proj[:, 1]
        ux, uy = obs[:, 0], obs[:, 1]
        A = torch.stack([
            torch.stack([seg(w * (px * px + py * py)), seg(w * px), seg(w * py)], -1),
            torch.stack([seg(w * px), seg(w), zc], -1),
            torch.stack([seg(w * py), zc, seg(w)], -1),
        ], dim=-2)
        b = torch.stack([seg(w * (px * ux + py * uy)), seg(w * ux), seg(w * uy)], dim=-1)
        n_obs = seg(valid.to(dtype))
        sol = torch.linalg.solve_ex(A + eye, b)[0]
        ok = n_obs >= 12
        s_new = torch.clamp(sol[:, 0], math.exp(-max_focal_step), math.exp(max_focal_step))
        d_new = torch.clamp(sol[:, 1:3], -max_pp_shift, max_pp_shift)
        s = torch.where(ok, s_new, s)
        d = torch.where(ok[:, None], d_new, d)

    model = proj * s[cam][:, None] + d[cam]
    r2 = torch.sum((model - obs) ** 2, dim=-1) * valid
    rms = torch.sqrt(torch.sum(r2) / torch.clamp_min(valid.sum(), 1))
    return s, d, rms
