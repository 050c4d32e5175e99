"""Bundle adjustment: Jacobi-preconditioned Gauss-Newton with conjugate
gradients, Huber IRLS weights and LM damping (the port of tpu_splat/sfm/ba.py).

The reference forms J^T(Jv) matrix-free with one jvp and one vjp per CG step.
Here each outer iteration builds the pinhole Jacobian analytically, once: every
observation touches one camera (6 columns), one point (3 columns) and the
shared focal and k1 corrections, so J is a (O, 2, 6) + (O, 2, 3) + (O, 2, 2)
set of blocks. A CG step is then a gather, a few elementwise products and
two segment sums, and the Jacobi preconditioner is the blocks' squared
column sums. It is the same Gauss-Newton system as the reference's (the
linearisation is at theta = 0, where exp_so3's derivative is hat(dw)).

Segment sums (the reference's `segment_sum`) go through `Segments`, in a
fixed order: `index_add_` is atomic on CUDA, so two identical calls would
round differently, and the mapper's accept cascade turns last-bit
differences into different reconstructions.

Observations carry a validity mask; invalid ones get zero weight.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from tpu_splat_torch.sfm.geometry import exp_so3, hat


class BAProblem(NamedTuple):
    cam_rotmats: torch.Tensor  # (C, 3, 3) w2c rotations (reference point)
    cam_trans: torch.Tensor  # (C, 3)
    points: torch.Tensor  # (P, 3)
    obs_cam: torch.Tensor  # (O,) int64
    obs_pt: torch.Tensor  # (O,) int64
    obs_uv: torch.Tensor  # (O, 2) normalised image coords
    obs_valid: torch.Tensor  # (O,) bool


class Segments:
    """Deterministic segment sums over fixed ids (observation -> camera or
    point): rows are sorted by id once, and each segment is summed in row
    order by `torch.segment_reduce`."""

    def __init__(self, ids: torch.Tensor, n: int):
        self.perm = torch.argsort(ids, stable=True)
        self.lengths = torch.bincount(ids, minlength=n)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(O, ...) per-row values -> (n, ...) per-segment sums."""
        return torch.segment_reduce(x[self.perm], "sum", lengths=self.lengths, axis=0)


def _residuals(theta: Dict[str, torch.Tensor], problem: BAProblem, weights: torch.Tensor,
               fixed_cam_mask: torch.Tensor, k1_base=0.0) -> torch.Tensor:
    """Weighted reprojection residuals (O, 2). theta = dict(dw, dt, dX[, df,
    dk1]): camera rotation/translation and point steps, a shared log-focal
    correction (the projection is scaled by exp(df)) and a shared
    SIMPLE_RADIAL k1 correction applied before the focal scale."""
    keep = (1.0 - fixed_cam_mask)[:, None]
    R = exp_so3(theta["dw"] * keep) @ problem.cam_rotmats
    t = problem.cam_trans + theta["dt"] * keep
    X = problem.points + theta["dX"]
    pc = torch.einsum("oij,oj->oi", R[problem.obs_cam], X[problem.obs_pt]) + t[problem.obs_cam]
    z = torch.clamp_min(pc[:, 2], 1e-6)
    proj = pc[:, :2] / z[:, None]
    if "dk1" in theta:
        r2 = torch.sum(proj**2, dim=-1, keepdim=True)
        proj = proj * (1.0 + (k1_base + theta["dk1"]) * r2)
    if "df" in theta:
        proj = proj * torch.exp(theta["df"])
    res = (proj - problem.obs_uv) * weights[:, None]
    return torch.where((pc[:, 2] > 1e-6)[:, None], res, torch.zeros_like(res))


def _huber_weights(problem, theta, fixed_cam_mask, delta, k1_base=0.0):
    ones = torch.ones_like(problem.obs_valid, dtype=torch.float32)
    e = torch.linalg.vector_norm(_residuals(theta, problem, ones, fixed_cam_mask, k1_base),
                                 dim=-1)
    w = torch.sqrt(torch.where(e <= delta, torch.ones_like(e),
                               delta / torch.clamp_min(e, 1e-12)))
    return w * problem.obs_valid.to(torch.float32)


def _jacobian_blocks(problem: BAProblem, weights, fixed, k1, optimize_focal, optimize_k1):
    """d residual / d theta at theta = 0, per observation: camera (O, 2, 6)
    [dw, dt], point (O, 2, 3) and shared (O, 2, E) [df?, dk1?] blocks."""
    Rc = problem.cam_rotmats[problem.obs_cam]
    q = torch.einsum("oij,oj->oi", Rc, problem.points[problem.obs_pt])
    pc = q + problem.cam_trans[problem.obs_cam]
    front = (pc[:, 2] > 1e-6).to(pc.dtype)
    z = torch.clamp_min(pc[:, 2], 1e-6)
    proj = pc[:, :2] / z[:, None]
    zeros = torch.zeros_like(z)
    dproj = torch.stack([torch.stack([1 / z, zeros, -proj[:, 0] / z], -1),
                         torch.stack([zeros, 1 / z, -proj[:, 1] / z], -1)], -2)  # (O, 2, 3)
    extra = []
    if optimize_k1:
        r2 = torch.sum(proj**2, dim=-1)
        lens = ((1.0 + k1 * r2)[:, None, None] * torch.eye(2, dtype=z.dtype, device=z.device)
                + 2 * k1 * proj[:, :, None] * proj[:, None, :])
        dproj = lens @ dproj
        proj_d = proj * (1.0 + k1 * r2)[:, None]
        dk1_col = proj * r2[:, None]
    else:
        proj_d = proj
    if optimize_focal:
        extra.append(proj_d)
    if optimize_k1:
        extra.append(dk1_col)
    scale = (weights * front)[:, None, None]
    j_pc = dproj * scale
    keep = (1.0 - fixed[problem.obs_cam])[:, None, None]
    j_cam = torch.cat([j_pc @ -hat(q), j_pc], dim=-1) * keep
    j_pt = j_pc @ Rc
    j_ext = (torch.stack(extra, -1) * scale if extra
             else z.new_zeros(z.shape + (2, 0)))
    return j_cam, j_pt, j_ext


def bundle_adjust(problem: BAProblem, huber_delta: float = 0.01, outer_iters: int = 8,
                  cg_iters: int = 24, lm_lambda: float = 1e-5, fix_first_cam: bool = True,
                  optimize_focal: bool = False, optimize_k1: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """Run BA; returns (cam_rotmats, cam_trans, points, rms_error, focal_scale,
    k1_delta), on the problem's device.

    With optimize_focal, a shared log-focal correction is estimated jointly
    (single-camera captures); the caller multiplies its fx/fy by the returned
    focal_scale (1.0 otherwise). With optimize_k1, a shared SIMPLE_RADIAL k1
    correction is estimated jointly; the caller adds the returned k1_delta to
    its current k1 (0.0 otherwise)."""
    dev, dt_ = problem.points.device, problem.points.dtype
    C, P = problem.cam_rotmats.shape[0], problem.points.shape[0]
    obs_cam, obs_pt = problem.obs_cam, problem.obs_pt
    fixed = torch.zeros((C,), dtype=dt_, device=dev)
    if fix_first_cam:
        fixed[0] = 1.0
    seg_cam, seg_pt = Segments(obs_cam, C), Segments(obs_pt, P)
    n_ext = int(optimize_focal) + int(optimize_k1)
    sizes = (6 * C, 3 * P, n_ext)

    def unflat(x):
        cam, pt, ext = torch.split(x, sizes)
        return cam.view(C, 6), pt.view(P, 3), ext

    def theta_of(x):
        cam, pt, ext = unflat(x)
        th = {"dw": cam[:, :3], "dt": cam[:, 3:], "dX": pt}
        names = [n for n, on in (("df", optimize_focal), ("dk1", optimize_k1)) if on]
        th.update({n: ext[i] for i, n in enumerate(names)})
        return th

    zero = torch.zeros(sum(sizes), dtype=dt_, device=dev)
    prob = problem
    log_s = torch.zeros((), dtype=dt_, device=dev)
    k1 = torch.zeros((), dtype=dt_, device=dev)
    for _ in range(outer_iters):
        theta0 = theta_of(zero)
        w = _huber_weights(prob, theta0, fixed, huber_delta, k1_base=k1)
        j_cam, j_pt, j_ext = _jacobian_blocks(prob, w, fixed, k1, optimize_focal, optimize_k1)
        r0 = _residuals(theta0, prob, w, fixed, k1_base=k1)

        def jt(u):  # J^T u for u (O, 2)
            g_cam = seg_cam((j_cam * u[:, :, None]).sum(1))
            g_pt = seg_pt((j_pt * u[:, :, None]).sum(1))
            g_ext = (j_ext * u[:, :, None]).sum((0, 1))
            return torch.cat([g_cam.reshape(-1), g_pt.reshape(-1), g_ext])

        def jv(v):  # J v -> (O, 2)
            cam, pt, ext = unflat(v)
            return ((j_cam * cam[obs_cam][:, None, :]).sum(-1)
                    + (j_pt * pt[obs_pt][:, None, :]).sum(-1) + j_ext @ ext)

        g = jt(r0)
        # exact Jacobi preconditioner: the squared column sums of J
        diag = torch.cat([seg_cam((j_cam**2).sum(1)).reshape(-1),
                          seg_pt((j_pt**2).sum(1)).reshape(-1), (j_ext**2).sum((0, 1))])
        diag = torch.clamp_min(diag, 1e-10)
        pre = diag * (1 + lm_lambda)

        def hvp(v):  # (J^T J + lambda diag(J^T J)) v
            return jt(jv(v)) + lm_lambda * diag * v

        x = torch.zeros_like(g)
        r = -g
        z_ = r / pre
        p = z_
        rz = torch.dot(r, z_)
        for _ in range(cg_iters):
            hp = hvp(p)
            alpha = rz / torch.clamp_min(torch.dot(p, hp), 1e-20)
            x = x + alpha * p
            r = r - alpha * hp
            z_ = r / pre
            rz_new = torch.dot(r, z_)
            p = z_ + rz_new / torch.clamp_min(rz, 1e-20) * p
            rz = rz_new

        # trust regions on the shared focal (5% per step) and k1 (0.02)
        if n_ext:
            lim = [v for v, on in ((0.05, optimize_focal), (0.02, optimize_k1)) if on]
            lim = torch.tensor(lim, dtype=dt_, device=dev)
            x = torch.cat([x[:-n_ext], torch.minimum(torch.maximum(x[-n_ext:], -lim), lim)])
        # accept the step only if the weighted cost does not increase; a half
        # step is the fallback before rejecting
        cost0 = torch.sum(r0**2)
        cost_full = torch.sum(_residuals(theta_of(x), prob, w, fixed, k1_base=k1) ** 2)
        cost_half = torch.sum(_residuals(theta_of(0.5 * x), prob, w, fixed, k1_base=k1) ** 2)
        use_half = (cost_half < cost_full) & (cost_half < cost0)
        use_full = (cost_full <= cost_half) & (cost_full < cost0)
        step = torch.where(use_full, 1.0, torch.where(use_half, 0.5, 0.0)).to(dt_)
        th = theta_of(step * x)
        keep = (1.0 - fixed)[:, None]
        obs_uv = prob.obs_uv
        if optimize_focal:
            # a focal step exp(df) on the model is folded into the problem by
            # scaling the observations by exp(-df)
            obs_uv = obs_uv * torch.exp(-th["df"])
            log_s = log_s + th["df"]
        if optimize_k1:
            k1 = k1 + th["dk1"]
        prob = prob._replace(cam_rotmats=exp_so3(th["dw"] * keep) @ prob.cam_rotmats,
                             cam_trans=prob.cam_trans + th["dt"] * keep,
                             points=prob.points + th["dX"], obs_uv=obs_uv)

    valid = prob.obs_valid.to(dt_)
    r = _residuals(theta_of(zero), prob, valid, fixed, k1_base=k1)
    rms = torch.sqrt(torch.sum(r**2) / torch.clamp_min(valid.sum(), 1.0))
    return prob.cam_rotmats, prob.cam_trans, prob.points, rms, torch.exp(log_s), k1


def reprojection_errors(problem: BAProblem) -> torch.Tensor:
    """Per-observation reprojection error (normalised units), inf for invalid."""
    Rc = problem.cam_rotmats[problem.obs_cam]
    pc = (torch.einsum("oij,oj->oi", Rc, problem.points[problem.obs_pt])
          + problem.cam_trans[problem.obs_cam])
    z = torch.clamp_min(pc[:, 2], 1e-6)
    err = torch.linalg.vector_norm(pc[:, :2] / z[:, None] - problem.obs_uv, dim=-1)
    inf = torch.full_like(err, float("inf"))
    err = torch.where(pc[:, 2] > 1e-6, err, inf)
    return torch.where(problem.obs_valid, err, inf)
