"""Parity of the port's bundle adjustment and per-camera intrinsics polish
(tpu_splat_torch/sfm/ba.py, intrinsics.py) with the JAX reference on the CPU,
on a seeded synthetic BAProblem: perturbed poses and points, pixel noise, a
few gross outliers and some invalid (padded) observations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.sfm import ba as jba
from tpu_splat.sfm import intrinsics as jintr
from tpu_splat.sfm.geometry import exp_so3 as jexp
from tpu_splat_torch.sfm import ba as tba
from tpu_splat_torch.sfm import intrinsics as tintr

torch.set_num_threads(1)


def max_rel(ref, got):
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(ref - np.asarray(got, np.float32))) / (np.max(np.abs(ref)) + 1e-12))


def synthetic_problem(seed, focal_scale=1.0, k1=0.0, n_cams=8, n_pts=160):
    """An arc of cameras at varied heights and distances around a point cloud
    that fills most of each view. The observations are made through a focal
    `focal_scale` and radial `k1` the problem does not know; the initial poses
    and points are perturbed."""
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-1, 1, (n_pts, 3)) * [2.0, 1.5, 2.0]).astype(np.float32)
    Rs, ts = [], []
    for i, a in enumerate(np.linspace(0, 1.2, n_cams)):
        r = 4.5 + 0.8 * np.sin(3 * i)
        eye = np.array([r * np.sin(a), 0.3 + 0.6 * np.cos(2 * i), -r * np.cos(a)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross([0.0, -1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Rs.append(R)
        ts.append(-R @ eye)
    Rs, ts = np.array(Rs, np.float32), np.array(ts, np.float32)
    cams, pids = np.meshgrid(np.arange(n_cams), np.arange(n_pts), indexing="ij")
    # every point in at least 3 views (a point seen once or twice is a ray or
    # a thin pair, left to the LM damping)
    keep = rng.uniform(size=cams.shape) < 0.6
    keep[rng.permuted(np.tile(np.arange(n_cams)[:, None], (1, n_pts)), axis=0) < 3] = True
    oc, op = cams[keep], pids[keep]
    pc = np.einsum("oij,oj->oi", Rs[oc], pts[op]) + ts[oc]
    uv = pc[:, :2] / pc[:, 2:]
    uv = uv * (1 + k1 * np.sum(uv**2, 1, keepdims=True)) * focal_scale
    uv = uv + rng.normal(0, 0.5 / 300, uv.shape)
    bad = rng.uniform(size=len(oc)) < 0.03
    uv[bad] += rng.normal(0, 0.05, (int(bad.sum()), 2))
    valid = rng.uniform(size=len(oc)) > 0.05
    dw = rng.normal(0, 0.01, (n_cams, 3)).astype(np.float32)
    dw[0] = 0
    R0 = np.asarray(jexp(jnp.asarray(dw))) @ Rs
    t0 = ts + rng.normal(0, 0.03, ts.shape) * (np.arange(n_cams) > 0)[:, None]
    X0 = pts + rng.normal(0, 0.03, pts.shape)
    arrays = (R0, t0, X0, oc, op, uv, valid)
    dtypes = (np.float32, np.float32, np.float32, np.int32, np.int32, np.float32, bool)
    return [np.asarray(a, d) for a, d in zip(arrays, dtypes)]


def as_jax(arrs):
    return jba.BAProblem(*map(jnp.asarray, arrs))


def as_torch(arrs):
    R, t, X, oc, op, uv, v = arrs
    T = torch.from_numpy
    return tba.BAProblem(T(R), T(t), T(X), T(oc).long(), T(op).long(), T(uv), T(v))


@pytest.mark.parametrize("calib", [False, True], ids=["pinhole", "focal+k1"])
def test_bundle_adjust_matches_reference(calib):
    """Final rms, poses and points within 1e-4 relative; with focal and k1
    refinement on, both are recovered, and two outer rounds of 4 CG steps
    agree to 1e-5 (k1 to 1e-6 absolute): the analytic Jacobian gives
    the reference's Gauss-Newton system. Longer CG chains in f32 amplify
    last bits along the weak (focal, k1, depth) direction: over seeds 0-9,
    scripts/compare_torch_sfm_ba.py finds the port as far from the
    reference as either package moves under a one-ulp change of its input,
    and as far from the reference's f64 answer as the reference's f32 one
    (ROADMAP queue 3)."""
    arrs = synthetic_problem(1, focal_scale=1.03 if calib else 1.0, k1=-0.05 if calib else 0.0)
    kw = dict(huber_delta=2.0 / 300, outer_iters=8, cg_iters=24, optimize_focal=calib,
              optimize_k1=calib)
    ref = jba.bundle_adjust(as_jax(arrs), **kw)
    got = tba.bundle_adjust(as_torch(arrs), **kw)
    for name, a, b in zip(("R", "t", "X", "rms"), ref, got):
        assert max_rel(a, b) <= 1e-4, name
    err_j = jba.reprojection_errors(jba.BAProblem(*ref[:3], *as_jax(arrs)[3:]))
    err_t = tba.reprojection_errors(tba.BAProblem(*got[:3], *as_torch(arrs)[3:]))
    assert np.array_equal(np.isinf(err_j), torch.isinf(err_t).numpy())
    fin = np.isfinite(np.asarray(err_j))
    assert max_rel(np.asarray(err_j)[fin], err_t.numpy()[fin]) <= 1e-3
    rms0 = float(tba.bundle_adjust(as_torch(arrs), **dict(kw, outer_iters=0))[3])
    assert float(got[3]) < 0.75 * rms0
    if not calib:
        assert float(got[4]) == 1.0 and float(got[5]) == 0.0
        return
    assert abs(float(got[4]) - 1.03) < 0.01 and abs(float(got[5]) + 0.05) < 0.01
    short = dict(kw, outer_iters=2, cg_iters=4)
    for name, a, b in zip(("R", "t", "X", "rms", "focal", "k1"),
                          jba.bundle_adjust(as_jax(arrs), **short),
                          tba.bundle_adjust(as_torch(arrs), **short)):
        assert (abs(float(a) - float(b)) <= 1e-6 if name == "k1" else max_rel(a, b) <= 1e-5), name


@pytest.mark.parametrize("seed", [0, 2, 6, 9])
def test_bundle_adjust_step_matches_reference_across_seeds(seed):
    """The Gauss-Newton step itself, on other seeds of the generator,
    including those whose 8 x 24-step chains drift farthest from the
    reference (6 and 9): two outer rounds of 4 CG steps with focal and k1 on
    agree within 1e-5 (k1 within 1e-6 absolute). The observations are padded
    with invalid rows to one length, so the reference compiles once."""
    R, t, X, oc, op, uv, v = synthetic_problem(seed, focal_scale=1.03, k1=-0.05)
    pad = 1024 - len(oc)
    arrs = [R, t, X, np.pad(oc, (0, pad)), np.pad(op, (0, pad)), np.pad(uv, ((0, pad), (0, 0))),
            np.pad(v, (0, pad))]
    kw = dict(huber_delta=2.0 / 300, outer_iters=2, cg_iters=4, optimize_focal=True,
              optimize_k1=True)
    for name, a, b in zip(("R", "t", "X", "rms", "focal", "k1"),
                          jba.bundle_adjust(as_jax(arrs), **kw),
                          tba.bundle_adjust(as_torch(arrs), **kw)):
        assert (abs(float(a) - float(b)) <= 1e-6 if name == "k1" else max_rel(a, b) <= 1e-5), name


def test_refine_intrinsics_matches_reference():
    """Per-camera focal scales and principal-point shifts within 1e-4, on
    the true geometry seen through a 4% longer focal."""
    R, t, X, oc, op, uv, v = synthetic_problem(1, focal_scale=1.04)
    rng = np.random.default_rng(2)
    arrs = [R, t, X, oc, op, uv + np.float32(0.002), v]
    arrs[2] = arrs[2] + rng.normal(0, 1e-3, X.shape).astype(np.float32)
    s_j, d_j, rms_j = jintr.refine_intrinsics_per_camera(as_jax(arrs))
    s_t, d_t, rms_t = tintr.refine_intrinsics_per_camera(as_torch(arrs))
    assert max_rel(s_j, s_t) <= 1e-4 and max_rel(d_j, d_t) <= 1e-4
    assert abs(float(rms_j) - float(rms_t)) <= 1e-4 * float(rms_j) + 1e-9
    assert np.all(np.abs(s_t.numpy() - 1.04) < 0.03)
