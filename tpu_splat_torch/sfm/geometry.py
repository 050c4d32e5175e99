"""Multi-view geometry: batched RANSAC (essential matrix, PnP), triangulation
and SE(3) utilities (the port of tpu_splat/sfm/geometry.py).

RANSAC is dense, as in the reference: all minimal-set hypotheses are drawn,
solved and scored against every correspondence at once. Functions take a
leading batch of problems where the reference's callers vmapped them, and run
on the device of their inputs.

Small SVDs go through `_right_vectors`, which hands cuSOLVER only square
matrices of at most 12 columns: tall systems are first reduced to their
triangular factor by an in-graph Householder QR (same right singular vectors
and values), because cuSOLVER's batched Jacobi SVD takes square matrices of
up to 32 columns only, and anything else falls back to one solver call per
matrix. LAPACK and cuSOLVER raise on non-finite input where the reference's
XLA calls return NaN, so those inputs have non-finite entries zeroed first
(`_finite`), and linear solves use `solve_ex`, which does not raise.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# A RANSAC draw: draw(stage, probs, n_hyp, n_sample) -> int64 indices. For
# one problem probs is (M,) and the result (n_hyp, n_sample); in the batched
# form probs is (P, M) and the result (P, n_hyp, n_sample).
Draw = Callable[[int, torch.Tensor, int, int], torch.Tensor]


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


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle."""
    tr = torch.clamp((torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1) / 2, -1.0, 1.0)
    theta = torch.arccos(tr)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = torch.where(theta < 1e-6, torch.full_like(theta, 0.5),
                        theta / (2 * torch.sin(theta) + 1e-12))
    return w * scale[..., None]


def _jacobian(f: Callable[[torch.Tensor], torch.Tensor], params: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian of a function batched over the leading dims of
    `params` (..., D) -> (..., R): (..., R, D). Each problem's residuals depend
    on its own parameters only, so one unit tangent per column, set in every
    problem at once, gives that column for all of them (the reference's
    vmapped jacfwd)."""
    d = params.shape[-1]
    eye = torch.eye(d, dtype=params.dtype, device=params.device)
    basis = eye.reshape((d,) + (1,) * (params.dim() - 1) + (d,)).expand((d,) + params.shape)
    cols = torch.func.vmap(lambda v: torch.func.jvp(f, (params,), (v,))[1])(basis)
    return cols.movedim(0, -1)


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, b)[0]


# cuSOLVER's batched eigensolver refuses large batches (syevBatched's
# workspace query fails with INVALID_VALUE at 65536 4x4 matrices on an H100),
# so large batches go through in slices
_SOLVER_BATCH = 1 << 13


def _in_slices(fn, A: torch.Tensor):
    """fn (a batched eigh or svd) on A (..., m, n), at most _SOLVER_BATCH
    matrices per call; returns fn's outputs with A's leading dims."""
    lead = A.shape[:-2]
    flat = A.reshape((-1,) + A.shape[-2:])
    parts = [fn(flat[i:i + _SOLVER_BATCH]) for i in range(0, max(flat.shape[0], 1),
                                                           _SOLVER_BATCH)]
    return tuple(torch.cat(p).reshape(lead + p[0].shape[1:]) for p in zip(*parts))


def _householder_r(A: torch.Tensor) -> torch.Tensor:
    """Upper-triangular factor (..., n, n) of a batched Householder QR of
    A (..., m, n), m >= n; Q is discarded."""
    m, n = A.shape[-2], A.shape[-1]
    rows = torch.arange(m, device=A.device)
    M = A
    for j in range(n):
        v = torch.where(rows >= j, M[..., :, j], torch.zeros((), dtype=A.dtype, device=A.device))
        nv = torch.linalg.vector_norm(v, dim=-1)
        sign = torch.where(v[..., j] >= 0, 1.0, -1.0)
        u = v + (rows == j).to(A.dtype) * (sign * nv)[..., None]
        u = u / torch.clamp_min(torch.linalg.vector_norm(u, dim=-1), 1e-30)[..., None]
        M = M - 2.0 * u[..., :, None] * (u[..., None, :] @ M)
    return torch.triu(M[..., :n, :])


def _right_vectors(A: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Right singular vectors of A (..., m, n) as rows (..., n, n), largest
    singular value first, and k = min(m, n): row k-1 is the reference's
    `svd(A, full_matrices=False)[2][-1]`. A tall A is reduced to its
    triangular factor, a wide one padded with zero rows, so the SVD is always
    square (see the module docstring)."""
    m, n = A.shape[-2], A.shape[-1]
    if m > n:
        A = _householder_r(A)
    elif m < n:
        A = torch.cat([A, A.new_zeros(A.shape[:-2] + (n - m, n))], dim=-2)
    return _in_slices(torch.linalg.svd, _finite(A))[2], min(m, n)


def _tri_solve_upper4(R: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled 4x4 back-substitution (R upper-triangular, diag pre-clamped)."""
    x3 = b[..., 3] / R[..., 3, 3]
    x2 = (b[..., 2] - R[..., 2, 3] * x3) / R[..., 2, 2]
    x1 = (b[..., 1] - R[..., 1, 2] * x2 - R[..., 1, 3] * x3) / R[..., 1, 1]
    x0 = (b[..., 0] - R[..., 0, 1] * x1 - R[..., 0, 2] * x2 - R[..., 0, 3] * x3) / R[..., 0, 0]
    return torch.stack([x0, x1, x2, x3], dim=-1)


def _tri_solve_lower4(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled 4x4 forward substitution (L lower-triangular)."""
    x0 = b[..., 0] / L[..., 0, 0]
    x1 = (b[..., 1] - L[..., 1, 0] * x0) / L[..., 1, 1]
    x2 = (b[..., 2] - L[..., 2, 0] * x0 - L[..., 2, 1] * x1) / L[..., 2, 2]
    x3 = (b[..., 3] - L[..., 3, 0] * x0 - L[..., 3, 1] * x1 - L[..., 3, 2] * x2) / L[..., 3, 3]
    return torch.stack([x0, x1, x2, x3], dim=-1)


def _smallest_right_vector4(A: torch.Tensor) -> torch.Tensor:
    """Smallest right-singular vector of batched (..., R, 4) DLT systems.

    Not an SVD and not eigh(A^T A): forming the Gram in f32 squares the
    condition number and destroys the null direction on drifty DLT systems
    (in the reference this bent the ring benchmark's recovered orbit, centre
    RMSE 0.66 -> 1.61). Instead: a Householder QR of A, then inverse
    iteration with the triangular factor (x <- R^-1 R^-T x), which applies
    (A^T A)^-1 stably, since the Gram is never formed. eigh of the 4x4 Gram
    only seeds the iteration. An all-zero A gives NaN, as in the reference."""
    R4 = _householder_r(A)
    # clamp the diagonal away from exact zero (perfect-data rank deficiency):
    # amplification caps at ~1e7, far past what 2 iterations need
    d = torch.diagonal(R4, dim1=-2, dim2=-1)
    floor = 1e-7 * torch.clamp_min(d.abs().amax(-1, keepdim=True), 1e-30)
    d_safe = torch.where(d.abs() < floor, torch.where(d >= 0, floor, -floor), d)
    R4 = R4 + torch.diag_embed(d_safe - d)
    _, v = _in_slices(torch.linalg.eigh, _finite(R4.mT @ R4))
    x = v[..., :, 0]
    for _ in range(2):
        y = _tri_solve_lower4(R4.mT, x)
        x = _tri_solve_upper4(R4, y)
        x = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-30)
    return x


def _dehomogenise(X: torch.Tensor) -> torch.Tensor:
    w = X[..., 3:]
    return X[..., :3] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """Two-view DLT triangulation. P: (..., 3, 4) projection matrices; x:
    (..., M, 2) pixel (or normalised) coords consistent with P. Returns
    (..., M, 3) points."""
    P1, P2 = P1[..., None, :, :], P2[..., None, :, :]
    A = torch.stack([
        x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)  # (..., M, 4, 4)
    return _dehomogenise(_smallest_right_vector4(A))


def triangulate_multiview(Ps: torch.Tensor, xs: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """N-view DLT: Ps (..., V, 3, 4); xs (..., V, 2); valid (..., V). Returns
    (..., 3) points. Rows from invalid views are zeroed."""
    rows_a = xs[..., 0:1] * Ps[..., 2, :] - Ps[..., 0, :]  # (..., V, 4)
    rows_b = xs[..., 1:2] * Ps[..., 2, :] - Ps[..., 1, :]
    A = torch.cat([rows_a, rows_b], dim=-2)  # (..., 2V, 4)
    w = torch.cat([valid, valid], dim=-1).to(A.dtype)[..., None]
    return _dehomogenise(_smallest_right_vector4(A * w))


def _design9(x1n: torch.Tensor, x2n: torch.Tensor) -> torch.Tensor:
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    return torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1)


def _eight_point(x1n: torch.Tensor, x2n: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Essential matrices (..., 3, 3) from batched (..., M, 2) normalised
    correspondences, projected onto the essential manifold. With `weights`
    (..., M), rows are scaled (zero weight = ignored)."""
    A = _design9(x1n, x2n)
    if weights is not None:
        A = A * weights[..., None]
    vt, k = _right_vectors(A)
    E = vt[..., k - 1, :].reshape(vt.shape[:-2] + (3, 3))
    u, s, vt2 = _in_slices(torch.linalg.svd, _finite(E))
    s_mean = (s[..., 0] + s[..., 1]) / 2
    diag = torch.stack([s_mean, s_mean, torch.zeros_like(s_mean)], dim=-1)
    return (u * diag[..., None, :]) @ vt2


@functools.lru_cache(maxsize=None)
def _fib_sphere_dirs_np(n: int) -> np.ndarray:
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
                    axis=-1).astype(np.float32)


def _lines(A: torch.Tensor, p: torch.Tensor, rows: int) -> torch.Tensor:
    """A[..., :rows, :] @ p^T -> (..., rows, M) for points p (..., M, 3), or
    (..., 1, M, 3) shared by a hypothesis axis of A (..., S, 3, 3): then one
    matrix product per problem, with the hypotheses stacked as rows, in place
    of a small product per hypothesis."""
    A = A[..., :rows, :]
    if p.dim() == A.dim() >= 3 and p.shape[-3] == 1 and A.shape[-3] > 1:
        s = A.shape[-3]
        out = A.reshape(A.shape[:-3] + (s * rows, 3)) @ p[..., 0, :, :].mT
        return out.reshape(A.shape[:-3] + (s, rows, p.shape[-2]))
    return A @ p.mT


def _sampson_terms(E: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Numerator x2'E x1 (..., M), squared-gradient denominator (..., M) and
    the epipolar lines E x1 (..., 3, M) and (E^T x2)[:2] (..., 2, M) of the
    Sampson distance, for homogeneous points p* as in `_lines`."""
    l1 = _lines(E, p1, 3)
    l2 = _lines(E.mT, p2, 2)
    x2, y2 = p2[..., 0], p2[..., 1]
    num = x2 * l1[..., 0, :] + y2 * l1[..., 1, :] + l1[..., 2, :]
    den = (l1[..., 0, :] * l1[..., 0, :] + l1[..., 1, :] * l1[..., 1, :]
           + l2[..., 0, :] * l2[..., 0, :] + l2[..., 1, :] * l2[..., 1, :])
    return num, den, l1, l2


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def sampson_error(E: torch.Tensor, x1n: torch.Tensor, x2n: torch.Tensor) -> torch.Tensor:
    """Sampson distance (..., M) of normalised correspondences (..., M, 2) to
    essential matrices (..., 3, 3)."""
    num, den, _, _ = _sampson_terms(E, _homogeneous(x1n), _homogeneous(x2n))
    return num * num / torch.clamp_min(den, 1e-12)


def _signed_sampson_jacobian(E: torch.Tensor, dE: torch.Tensor, p1: torch.Tensor,
                             p2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed Sampson residuals r (P, C, M) of hypotheses E (P, C, 3, 3) at
    points p* (P, 1, M, 3), and their Jacobian (P, C, M, D) given
    dE = d vec(E) / d params (P, C, 9, D). With r = n / s, n = x2' E x1 and
    s^2 = the denominator, a tangent G of E moves r by
    x2' G x1 / s - n / s^3 (l1_0 (G x1)_0 + l1_1 (G x1)_1 + l2_0 (G' x2)_0
    + l2_1 (G' x2)_1): the reference's forward-mode Jacobian, in closed form."""
    num, den, l1, l2 = _sampson_terms(E, p1, p2)
    s = torch.sqrt(torch.clamp_min(den, 1e-12))
    P, C, _, D = dE.shape
    G = dE.movedim(-1, -2).reshape(P, C * D, 3, 3)
    m = p1.shape[-2]
    g1 = _lines(G, p1, 3).reshape(P, C, D, 3, m)  # G x1
    g2 = _lines(G.mT, p2, 2).reshape(P, C, D, 2, m)  # (G^T x2)[:2]
    x2, y2 = p2[..., None, :, 0], p2[..., None, :, 1]  # (P, 1, 1, M)
    dnum = x2 * g1[..., 0, :] + y2 * g1[..., 1, :] + g1[..., 2, :]
    dden = (l1[:, :, None, 0] * g1[..., 0, :] + l1[:, :, None, 1] * g1[..., 1, :]
            + l2[:, :, None, 0] * g2[..., 0, :] + l2[:, :, None, 1] * g2[..., 1, :])
    c = torch.where(den > 1e-12, num / (s * s * s), torch.zeros_like(num))
    J = dnum / s[:, :, None] - c[:, :, None] * dden
    return num / s, J.movedim(2, -1)


def multinomial_draw(generator: Optional[torch.Generator]) -> Draw:
    """The default RANSAC draw: rows of `probs` (P, M) sampled with
    replacement from the explicit generator. A row that sums to zero (an empty
    consensus, or a pair with no valid row) draws uniformly: torch.multinomial
    refuses it, and the `valid` mask keeps such samples from mattering."""

    def draw(stage, probs, n_hyp, n_sample):
        empty = probs.sum(-1, keepdim=True) <= 0
        probs = torch.where(empty, torch.ones_like(probs), probs)
        idx = torch.multinomial(probs, n_hyp * n_sample, replacement=True, generator=generator)
        return idx.view(probs.shape[0], n_hyp, n_sample)

    return draw


def _single_draw(draw: Draw) -> Draw:
    """Lift a one-problem draw to the batched form (P = 1)."""
    return lambda stage, probs, n_hyp, n_sample: draw(stage, probs[0], n_hyp, n_sample)[None]


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (P, M, C) gathered at idx (P, S, n) -> (P, S, n, C)."""
    p = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[p, idx]


def _stage_probs(mask: torch.Tensor) -> torch.Tensor:
    p = mask.to(torch.float32)
    return p / torch.clamp_min(p.sum(-1, keepdim=True), 1.0)


_W90 = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def _proper_svd(E: torch.Tensor):
    """SVD of (..., 3, 3) with both factors turned into proper rotations."""
    u, _, vt = _in_slices(torch.linalg.svd, _finite(E))
    u = u * torch.sign(torch.linalg.det(u))[..., None, None]
    vt = vt * torch.sign(torch.linalg.det(vt))[..., None, None]
    return u, vt


def _essential_ransac_batched(x1n, x2n, valid, thresholds, draw: Draw,
                              num_hypotheses: int, n_fib: int, pre_steps: int):
    """essential_ransac over a leading pair axis P: x*n (P, M, 2), valid
    (P, M), thresholds (P,). Returns (E (P, 3, 3), inliers (P, M))."""
    P = x1n.shape[0]
    ar = torch.arange(P, device=x1n.device)
    t2 = (thresholds ** 2)[:, None]  # (P, 1)
    t2_sel = ((thresholds / 4.0) ** 2)[:, None]

    def msac_cost(errs, cap):
        # errs (P, S, M); invalid rows contribute the cap
        cap = cap[:, :, None]
        return torch.where(valid[:, None, :], torch.minimum(errs, cap), cap).sum(-1)

    def stage(stage_i, probs, n_sample, n_hyp):
        idx = draw(stage_i, probs, n_hyp, n_sample)
        Es = _eight_point(_rows(x1n, idx), _rows(x2n, idx))  # (P, S, 3, 3)
        errs = sampson_error(Es, x1n[:, None], x2n[:, None])  # (P, S, M)
        best = torch.argmin(msac_cost(errs, t2), dim=-1)
        inl = (errs[ar, best] < t2) & valid
        return Es[ar, best], inl

    _, inl = stage(0, _stage_probs(valid), 8, num_hypotheses)
    _, inl = stage(1, _stage_probs(inl), 24, num_hypotheses // 2)
    E_best, inl_best = stage(2, _stage_probs(inl), 40, num_hypotheses // 2)

    # Quasi-degeneracy rescue + multistart polish (reference geometry.py:273-
    # 331): refit on the consensus, span the last 3 right singular vectors
    # with a Fibonacci sphere, GN-polish every candidate `pre_steps` times,
    # keep the best by tight-truncation MSAC, then polish it fully.
    p1 = _homogeneous(x1n)[:, None]  # (P, 1, M, 3)
    p2 = _homogeneous(x2n)[:, None]
    W = torch.tensor(_W90, dtype=x1n.dtype, device=x1n.device)
    thr = thresholds[:, None, None]

    def polish(E_init, n_steps):
        # E_init (P, C, 3, 3): trimmed Gauss-Newton on the essential manifold
        u, vt = _proper_svd(E_init)
        R0 = u @ W @ vt
        t0 = u[..., :, 2]

        def E_of(params):
            w, dt = params[..., :3], params[..., 3:]
            t = t0 + dt
            t = t / torch.clamp_min(torch.linalg.vector_norm(t, dim=-1, keepdim=True), 1e-9)
            return hat(t) @ (exp_so3(w) @ R0)

        def vec_E(params):
            return E_of(params).flatten(-2)

        params = E_init.new_zeros(E_init.shape[:-2] + (6,))
        eye = 1e-4 * torch.eye(6, dtype=x1n.dtype, device=x1n.device)
        for _ in range(n_steps):
            # residuals (P, C, M) and Jacobian (P, C, M, 6)
            r, J = _signed_sampson_jacobian(E_of(params), _jacobian(vec_E, params), p1, p2)
            wgt = ((r.abs() < thr) & valid[:, None, :]).to(x1n.dtype)
            JW = J * wgt[..., None]
            H = JW.mT @ J + eye
            params = params - _solve(H, JW.mT @ r[..., None])[..., 0]
        return E_of(params)

    def sel_cost(E):  # E (P, C, 3, 3) -> (P, C)
        return msac_cost(sampson_error(E, x1n[:, None], x2n[:, None]), t2_sel)

    if n_fib > 0:
        A = _design9(x1n, x2n) * inl_best.to(x1n.dtype)[..., None]
        vtA, _ = _right_vectors(A)
        basis = vtA[..., -3:, :]  # (P, 3, 9)
        dirs = torch.from_numpy(_fib_sphere_dirs_np(n_fib)).to(x1n.device)
        cands = (dirs @ basis).reshape(P, n_fib, 3, 3)
        cands = torch.cat([E_best[:, None], cands], dim=1)
        pre = polish(cands, pre_steps)
        E_win = pre[ar, torch.argmin(sel_cost(pre), dim=-1)]
    else:
        E_win = E_best
    E_ref = polish(E_win[:, None], 10)[:, 0]
    cost_ref = sel_cost(E_ref[:, None])[:, 0]
    best_cost = sel_cost(E_best[:, None])[:, 0]
    E_out = torch.where((best_cost <= cost_ref)[:, None, None], E_best, E_ref)
    inl_out = (sampson_error(E_out, x1n, x2n) < t2) & valid
    return E_out, inl_out


def essential_ransac(x1n: torch.Tensor, x2n: torch.Tensor, valid: torch.Tensor,
                     threshold: float, num_hypotheses: int = 512, n_fib: int = 128,
                     pre_steps: int = 3, generator: Optional[torch.Generator] = None,
                     draw: Optional[Draw] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Progressive batched-RANSAC essential matrix of one pair.

    x*n: (M, 2) normalised camera coords; threshold in normalised units
    (pixel_threshold / focal). Returns (E (3, 3), inliers (M,)).

    Stage 1 draws minimal 8-point samples from all matches; stages 2 and 3
    redraw 24- and 40-point least-squares samples from the previous
    consensus. Hypotheses are selected by MSAC score (the sum of
    threshold-truncated squared Sampson errors), then a Fibonacci-sphere
    multistart polish escapes the rotation-dominant quasi-degenerate basin
    (reference geometry.py:217-290 says why). `draw(stage, probs, n_hyp,
    n_sample)` picks each stage's samples; by default they come from
    `generator`."""
    d = multinomial_draw(generator) if draw is None else _single_draw(draw)
    thr = torch.full((1,), float(threshold), dtype=x1n.dtype, device=x1n.device)
    E, inl = _essential_ransac_batched(x1n[None], x2n[None], valid[None], thr, d,
                                       num_hypotheses, n_fib, pre_steps)
    return E[0], inl[0]


def essential_ransac_pairs(x1n: torch.Tensor, x2n: torch.Tensor, valid: torch.Tensor,
                           thresholds: torch.Tensor, num_hypotheses: int = 512,
                           generator: Optional[torch.Generator] = None,
                           draw: Optional[Draw] = None,
                           chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """essential_ransac over a leading pair axis: x*n (P, M, 2), valid (P, M),
    thresholds (P,) (they may differ per pair, as in the focal sweep). Pairs
    go `chunk` at a time to bound the (pairs x hypotheses x matches) scores.
    Returns (E (P, 3, 3), inliers (P, M))."""
    draw = multinomial_draw(generator) if draw is None else draw
    Es, inls = [], []
    for i in range(0, x1n.shape[0], chunk):
        s = slice(i, i + chunk)
        E, inl = _essential_ransac_batched(x1n[s], x2n[s], valid[s], thresholds[s], draw,
                                           num_hypotheses, 128, 3)
        Es.append(E)
        inls.append(inl)
    return torch.cat(Es), torch.cat(inls)


def decompose_essential(E: torch.Tensor, x1n: torch.Tensor, x2n: torch.Tensor,
                        inliers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """E (..., 3, 3) -> (R, t) of camera 2 in camera-1 frame (w2c convention:
    x2 = R x1 + t), selecting the chirality with the most inliers in front of
    both cameras. x*n (..., M, 2), inliers (..., M)."""
    u, vt = _proper_svd(E)
    W = torch.tensor(_W90, dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)  # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=-2)  # (..., 4, 3)
    eye = torch.eye(3, 4, dtype=E.dtype, device=E.device)
    P2 = torch.cat([Rs, ts[..., None]], dim=-1)
    X = triangulate_dlt(eye.expand(P2.shape), P2, x1n[..., None, :, :], x2n[..., None, :, :])
    z1 = X[..., 2]
    z2 = (X @ Rs.mT + ts[..., None, :])[..., 2]
    counts = ((z1 > 0) & (z2 > 0) & inliers[..., None, :]).sum(-1)
    best = torch.argmax(counts, dim=-1)[..., None]
    R = torch.gather(Rs, -3, best[..., None, None].expand(best.shape + (3, 3)))[..., 0, :, :]
    tb = torch.gather(ts, -2, best[..., None].expand(best.shape + (3,)))[..., 0, :]
    return R, tb


def decompose_essential_pairs(Es, x1n, x2n, inliers):
    """decompose_essential over a leading pair axis (the batched form the
    reference chunks for its compile cache). Returns (R (P,3,3), t (P,3))."""
    return decompose_essential(Es, x1n, x2n, inliers)


def umeyama_alignment(src: torch.Tensor, dst: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Similarity transform (s, R, t) minimising ||dst - (s R src + t)||^2
    (Umeyama's closed form through the SVD of the cross-covariance)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    u, s, vt = torch.linalg.svd(_finite(cov))
    d = torch.sign(torch.linalg.det(u @ vt))
    S = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    R = (u * S) @ vt
    var_s = torch.mean(torch.sum(sc**2, dim=-1))
    scale = torch.sum(s * S) / torch.clamp_min(var_s, 1e-12)
    t = mu_d - scale * R @ mu_s
    return scale, R, t


def _pnp_dlt(X: torch.Tensor, xn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projection-matrix DLT from batched (..., n, 3) / (..., n, 2) 3D-2D
    correspondences (normalised coords), then orthogonalisation of the
    rotation block."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # (..., n, 4)
    zeros = torch.zeros_like(Xh)
    rows1 = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], dim=-1)  # (..., n, 12)
    rows2 = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], dim=-1)
    vt, k = _right_vectors(torch.cat([rows1, rows2], dim=-2))
    P = vt[..., k - 1, :].reshape(vt.shape[:-2] + (3, 4))
    # fix sign: points should be in front
    depths = (Xh * P[..., None, 2, :]).sum(-1)
    P = P * torch.sign(torch.sign(depths).sum(-1))[..., None, None]
    u, s, vt2 = _in_slices(torch.linalg.svd, _finite(P[..., :3]))
    sgn = torch.sign(torch.linalg.det(u @ vt2))
    R = (u @ vt2) * sgn[..., None, None]
    scale = s.mean(-1) * sgn
    t = P[..., 3] / torch.where(scale.abs() < 1e-12, torch.full_like(scale, 1e-12),
                                scale)[..., None]
    return R, t


def pnp_ransac(points3d: torch.Tensor, points2d_n: torch.Tensor, valid: torch.Tensor,
               threshold: float, num_hypotheses: int = 256,
               generator: Optional[torch.Generator] = None, draw: Optional[Draw] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Progressive batched-RANSAC PnP (the staging of essential_ransac):
    points3d (M, 3), points2d_n (M, 2) normalised coords, valid (M,).
    Returns (R, t, inliers)."""
    d = multinomial_draw(generator) if draw is None else _single_draw(draw)
    X, x = points3d[None], points2d_n[None]
    t2 = torch.tensor(threshold, dtype=torch.float32) ** 2

    def stage(stage_i, probs, n_sample, n_hyp):
        idx = d(stage_i, probs, n_hyp, n_sample)
        Rs, ts = _pnp_dlt(_rows(X, idx), _rows(x, idx))  # (1, S, 3, 3), (1, S, 3)
        pc = X[:, None] @ Rs.mT + ts[..., None, :]  # (1, S, M, 3)
        z = pc[..., 2]
        z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        err = torch.sum((pc[..., :2] / z[..., None] - x[:, None]) ** 2, dim=-1)
        err = torch.where(pc[..., 2] > 0, err, torch.full_like(err, float("inf")))
        inl = (err < t2) & valid[None, None]
        best = torch.argmax(inl.sum(-1), dim=-1)[0]
        return Rs[0, best], ts[0, best], inl[0, best]

    _, _, inl = stage(0, _stage_probs(valid[None]), 6, num_hypotheses)
    _, _, inl = stage(1, _stage_probs(inl[None]), 16, num_hypotheses // 2)
    return stage(2, _stage_probs(inl[None]), 32, num_hypotheses // 2)


def _project_residuals(R, t, points3d, points2d_n):
    pc = points3d @ R.mT + t[..., None, :]
    z = torch.clamp_min(pc[..., 2], 1e-6)
    return pc[..., :2] / z[..., None] - points2d_n, pc


def pnp_refine_annealed(R0: torch.Tensor, t0: torch.Tensor, points3d: torch.Tensor,
                        points2d_n: torch.Tensor, valid: torch.Tensor, threshold: float,
                        iters: int = 20, start_multiplier: float = 8.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trimmed Gauss-Newton PnP from pose seeds, with an annealed inlier gate
    from `start_multiplier * threshold` down to `threshold`.

    R0 (..., 3, 3), t0 (..., 3): a batch of seeds, each refined against the
    same (M, 3) / (M, 2) correspondences. Returns (R, t, inliers (..., M))."""

    def resid(params):
        R = exp_so3(params[..., :3]) @ R0
        r, _ = _project_residuals(R, t0 + params[..., 3:], points3d, points2d_n)
        return r.flatten(-2)

    params = R0.new_zeros(R0.shape[:-2] + (6,))
    eye = 1e-5 * torch.eye(6, dtype=R0.dtype, device=R0.device)
    decay = torch.tensor(0.8, dtype=torch.float32)
    thr32 = torch.tensor(threshold, dtype=torch.float32)
    for it in range(iters):
        anneal = float(torch.clamp_min(start_multiplier * decay ** it, 1.0) * thr32)
        r = resid(params)
        e = torch.linalg.vector_norm(r.unflatten(-1, (-1, 2)), dim=-1)
        wgt = ((e < anneal) & valid).to(R0.dtype)
        J = _jacobian(resid, params)  # (..., 2M, 6)
        JW = J * wgt.repeat_interleave(2, dim=-1)[..., None]
        H = JW.mT @ J + eye
        params = params - _solve(H, JW.mT @ r[..., None])[..., 0]
    R = exp_so3(params[..., :3]) @ R0
    t = t0 + params[..., 3:]
    r, pc = _project_residuals(R, t, points3d, points2d_n)
    inl = (torch.linalg.vector_norm(r, dim=-1) < threshold) & (pc[..., 2] > 0) & valid
    return R, t, inl


def refine_pnp(R: torch.Tensor, t: torch.Tensor, points3d: torch.Tensor,
               points2d_n: torch.Tensor, weights: torch.Tensor, iters: int = 10
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton refinement of a single camera pose on weighted inliers."""

    def residuals(params):
        r, _ = _project_residuals(exp_so3(params[:3]) @ R, params[3:], points3d, points2d_n)
        return (r * weights[:, None]).reshape(-1)

    params = torch.cat([R.new_zeros(3), t])
    eye = 1e-6 * torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        J = torch.func.jacfwd(residuals)(params)
        r = residuals(params)
        params = params - _solve(J.T @ J + eye, J.T @ r)
    return exp_so3(params[:3]) @ R, params[3:]
