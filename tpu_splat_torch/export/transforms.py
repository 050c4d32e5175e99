"""Splat rigid transforms: rotation and mirroring with full SH band rotation
(the port's copy of tpu_splat/export/transforms.py: numpy on the exported
cloud, as in the reference).

Replaces rotate_splat.py / mirror_splat.py from the reference. The reference only
rotates the degree-1 SH band (rotate_splat.py:140-176, acknowledged-unhandled for
higher degrees, causing view-dependent color artifacts); here all bands (degree
<= 3) are rotated exactly with real-SH Wigner-D matrices built by the
Ivanic-Ruedenberg recurrence. Mirroring decomposes the reflection into a proper
rotation times point inversion (which acts on band l as (-1)^l).

Rotation-spec strings ("x:270,y:180,z:0") follow the reference CLI format
(rotate_splat.py:278-308); listed rotations compose left-to-right (each applied
after the previous).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from tpu_splat_torch.core.types import GaussianCloud


def axis_rotation(axis: str, degrees: float) -> np.ndarray:
    a = math.radians(degrees)
    c, s = math.cos(a), math.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
    raise ValueError(f"unknown axis {axis!r}")


def parse_rotation_spec(spec: str) -> np.ndarray:
    """'x:270,y:180' -> composed 3x3 rotation (applied in listed order)."""
    R = np.eye(3)
    for part in spec.split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        axis, angle = part.split(":")
        R = axis_rotation(axis.strip().lower(), float(angle)) @ R
    return R


# ---------------------------------------------------------------------------
# Real-SH Wigner-D matrices (Ivanic & Ruedenberg 1996, with the 1998 erratum).
# ---------------------------------------------------------------------------


def _band1_matrix(R: np.ndarray) -> np.ndarray:
    """Band-1 real-SH rotation in coefficient order m = -1, 0, +1 ~ (y, z, x)."""
    # permutation (x,y,z) -> (y,z,x)
    return np.array(
        [
            [R[1, 1], R[1, 2], R[1, 0]],
            [R[2, 1], R[2, 2], R[2, 0]],
            [R[0, 1], R[0, 2], R[0, 0]],
        ]
    )


def _next_band(l: int, R1: np.ndarray, Rp: np.ndarray) -> np.ndarray:
    """Band-l matrix from the band-(l-1) matrix Rp via the IR recurrence."""

    def P(i, a, b):
        ri1, ri0, rim1 = R1[i + 1, 2], R1[i + 1, 1], R1[i + 1, 0]
        if b == l:
            return ri1 * Rp[a + l - 1, 2 * l - 2] - rim1 * Rp[a + l - 1, 0]
        if b == -l:
            return ri1 * Rp[a + l - 1, 0] + rim1 * Rp[a + l - 1, 2 * l - 2]
        return ri0 * Rp[a + l - 1, b + l - 1]

    def U(m, n):
        return P(0, m, n)

    def V(m, n):
        if m == 0:
            return P(1, 1, n) + P(-1, -1, n)
        if m > 0:
            d = 1.0 if m == 1 else 0.0
            return P(1, m - 1, n) * math.sqrt(1 + d) - P(-1, -m + 1, n) * (1 - d)
        d = 1.0 if m == -1 else 0.0
        return P(1, m + 1, n) * (1 - d) + P(-1, -m - 1, n) * math.sqrt(1 + d)

    def W(m, n):
        if m == 0:
            return 0.0
        if m > 0:
            return P(1, m + 1, n) + P(-1, -m - 1, n)
        return P(1, m - 1, n) - P(-1, -m + 1, n)

    out = np.zeros((2 * l + 1, 2 * l + 1))
    for m in range(-l, l + 1):
        d = 1.0 if m == 0 else 0.0
        for n in range(-l, l + 1):
            denom = float((2 * l) * (2 * l - 1)) if abs(n) == l else float(
                (l + n) * (l - n)
            )
            u = math.sqrt((l + m) * (l - m) / denom)
            v = (
                0.5
                * math.sqrt((1 + d) * (l + abs(m) - 1) * (l + abs(m)) / denom)
                * (1 - 2 * d)
            )
            w = -0.5 * math.sqrt((l - abs(m) - 1) * (l - abs(m)) / denom) * (1 - d)
            val = 0.0
            if u != 0.0:
                val += u * U(m, n)
            if v != 0.0:
                val += v * V(m, n)
            if w != 0.0:
                val += w * W(m, n)
            out[m + l, n + l] = val
    return out


def sh_rotation_matrices(R: np.ndarray, max_degree: int) -> List[np.ndarray]:
    """Real-SH rotation matrix per band 1..max_degree for a proper rotation R,
    in the 3DGS basis convention.

    The IR recurrence produces matrices for the plain (y, z, x)-signed real SH;
    the 3DGS/gsplat basis carries Condon-Shortley-style signs s_m = (-1)^m, so
    each band matrix is conjugated by diag(s) (validated against a Monte-Carlo
    fit of eval_sh_basis in tests/test_transforms.py)."""
    mats: List[np.ndarray] = []
    if max_degree >= 1:
        mats.append(_band1_matrix(R))
        for l in range(2, max_degree + 1):
            mats.append(_next_band(l, mats[0], mats[-1]))
        fixed = []
        for l, D in enumerate(mats, start=1):
            s = np.array([(-1.0) ** m for m in range(-l, l + 1)])
            fixed.append(np.diag(s) @ D @ np.diag(s))
        mats = fixed
    return mats


def rotate_sh(shN: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Rotate SH rest coefficients (N, K, 3), coefficient-major, all bands."""
    k = shN.shape[1]
    degree = {0: 0, 3: 1, 8: 2, 15: 3}.get(k)
    if degree is None:
        raise ValueError(f"unsupported SH coefficient count {k}")
    if degree == 0:
        return shN
    mats = sh_rotation_matrices(R, degree)
    out = shN.copy()
    offset = 0
    for l, D in enumerate(mats, start=1):
        size = 2 * l + 1
        block = shN[:, offset : offset + size, :]  # (N, size, 3)
        out[:, offset : offset + size, :] = np.einsum("ab,nbc->nac", D, block)
        offset += size
    return out


def _quat_mul_wxyz(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def _rotmat_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def rotate_splat(cloud: GaussianCloud, rotation) -> GaussianCloud:
    """Rotate a splat rigidly: positions, orientations, and all SH bands.

    rotation: 3x3 matrix or a spec string like "x:270,y:180"."""
    R = parse_rotation_spec(rotation) if isinstance(rotation, str) else np.asarray(rotation)
    g = cloud.to_numpy()
    means = g.means @ R.T.astype(np.float32)
    rq = _rotmat_to_quat_wxyz(R).astype(np.float32)
    quats = _quat_mul_wxyz(np.broadcast_to(rq, g.quats.shape), g.quats)
    shN = rotate_sh(g.shN.astype(np.float64), R).astype(np.float32)
    return GaussianCloud(
        means=means.astype(np.float32),
        scales=g.scales,
        quats=quats.astype(np.float32),
        opacities=g.opacities,
        sh0=g.sh0,
        shN=shN,
        antialiased=cloud.antialiased,
    )


def mirror_splat(cloud: GaussianCloud, axis: str = "x") -> GaussianCloud:
    """Mirror a splat across the plane normal to `axis` (mirror_splat.py analog,
    but with exact SH reflection for all bands).

    Reflection M = diag(+-1). For orientations, each gaussian's rotation matrix
    becomes M R_g M' ... practically: covariance transforms as M Sigma M^T, and
    since M is diagonal +-1 the principal axes keep their scales while the
    rotation matrix gets its handedness fixed by negating one column (the
    reference's det<0 fix, mirror_splat.py:33-168). For SH: M = R_pi(axis) * (-I),
    and (-I) multiplies band l by (-1)^l."""
    ax = {"x": 0, "y": 1, "z": 2}[axis]
    M = np.eye(3)
    M[ax, ax] = -1.0
    g = cloud.to_numpy()
    means = (g.means @ M.T).astype(np.float32)

    # Orientation: R_new = M R_old with handedness fix (negate first column).
    # Equivalent quaternion algebra, done via rotation matrices per gaussian.
    q = g.quats
    nrm = np.linalg.norm(q, axis=1, keepdims=True)
    qn = q / np.maximum(nrm, 1e-12)
    w, x, y, z = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    Rg = np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(-1, 3, 3)
    Rm = M[None] @ Rg
    Rm[:, :, 0] *= -1.0  # restore det=+1; swaps handedness into the first scale axis
    quats = np.stack([_rotmat_to_quat_wxyz(r) for r in Rm]).astype(np.float32)
    quats *= nrm  # preserve original (unnormalized) magnitudes

    # SH reflection: D_l(M) = (-1)^l D_l(R_pi(axis)).
    k = g.shN.shape[1]
    degree = {0: 0, 3: 1, 8: 2, 15: 3}.get(k, 0)
    shN = g.shN.astype(np.float64)
    if degree >= 1:
        R_pi = axis_rotation(axis, 180.0)
        mats = sh_rotation_matrices(R_pi, degree)
        out = shN.copy()
        offset = 0
        for l, D in enumerate(mats, start=1):
            size = 2 * l + 1
            block = shN[:, offset : offset + size, :]
            out[:, offset : offset + size, :] = ((-1.0) ** l) * np.einsum(
                "ab,nbc->nac", D, block
            )
            offset += size
        shN = out
    return GaussianCloud(
        means=means,
        scales=g.scales,
        quats=quats,
        opacities=g.opacities,
        sh0=g.sh0,
        shN=shN.astype(np.float32),
        antialiased=cloud.antialiased,
    )
