"""Metric-scale estimation from a tripod-height reference (the port of
tpu_splat/export/measurement.py).

The reference's estimate_scale_from_tripod.py semantics: RANSAC a ground
plane through the splat points (500 iterations, inlier threshold 0.5% of the
bbox diagonal, plane normal must have a dominant axis component >= 0.85, score =
inliers weighted by how one-sided the cameras are), measure the median camera
height above the plane, and derive meters-per-model-unit from the known tripod
height. Emits the measurement JSON with a coefficient-of-variation confidence and
robust (percentile) bounding-box dimensions.

The hypotheses are drawn on the host with the caller's numpy generator, in the
reference's order, so they are the reference's; every hypothesis is then
scored at once on the device in f64 (in chunks that bound hypotheses x
points), and the first best wins, as the reference's `score > best_score`
keeps it. The reference computes in its input's dtype (f32 for a splat's
means); the port always in f64.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device

F64 = torch.float64
SCORE_CHUNK = 1 << 25  # hypotheses x points scored at once


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """numpy's default (linear) quantile along dim 0 (torch.quantile's
    method), written out in numpy's order of operations: the virtual index
    (n - 1) q and the two-sided lerp as separate roundings (torch's CPU lerp
    fuses a multiply-add), so the result is numpy's to the last bit."""
    n = x.shape[0]
    s = torch.sort(x, dim=0).values
    virtual = (n - 1) * q
    if virtual >= n - 1:
        return s[n - 1]
    below = int(np.floor(virtual))
    t = virtual - below
    a, b = s[below], s[below + 1]
    diff = b - a
    return a + diff * t if t < 0.5 else b - diff * (1 - t)


def _draw_triples(rng: np.random.Generator, n_pts: int, iterations: int) -> np.ndarray:
    """The reference's per-iteration rng.choice(n_pts, 3, replace=False), all
    drawn up front (nothing else draws from `rng` in between)."""
    return np.stack([rng.choice(n_pts, 3, replace=False) for _ in range(iterations)])


def best_plane(
    points: torch.Tensor,
    rng: np.random.Generator,
    iterations: int = 500,
    threshold_frac: float = 0.005,
    min_axis_component: float = 0.85,
    camera_centers: Optional[np.ndarray] = None,
) -> Optional[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]]:
    """RANSAC over f64 `points` (N, 3) on their device. Returns (winning
    hypothesis index, normal (3,), d (), inlier mask (N,)) or None."""
    n_pts = points.shape[0]
    if n_pts < 10:
        return None
    dev = points.device
    lo, hi = points.min(0).values, points.max(0).values
    diag = float(np.linalg.norm((hi - lo).cpu().numpy()))
    threshold = max(diag * threshold_frac, 1e-9)

    idx = torch.as_tensor(_draw_triples(rng, n_pts, iterations), device=dev)
    p0, p1, p2 = points[idx[:, 0]], points[idx[:, 1]], points[idx[:, 2]]
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    nn = torch.linalg.vector_norm(n, dim=1)
    n = n / torch.where(nn < 1e-12, torch.ones_like(nn), nn)[:, None]
    # skip degenerate triples and normals not axis-aligned enough to be a floor
    ok = (nn >= 1e-12) & (n.abs().max(1).values >= min_axis_component)
    d = -torch.sum(n * p0, dim=1)

    chunk = max(1, SCORE_CHUNK // n_pts)
    counts = torch.cat([
        (torch.abs(points @ n[s:s + chunk].T + d[s:s + chunk]) < threshold).sum(0)
        for s in range(0, iterations, chunk)])
    score = counts.to(F64)
    if camera_centers is not None and len(camera_centers):
        cams = torch.as_tensor(np.asarray(camera_centers, np.float64), device=dev)
        side = torch.sign(cams @ n.T + d)  # (C, H)
        one_sidedness = torch.abs(side.sum(0)) / len(cams)
        score = score * (0.5 + 0.5 * one_sidedness)
    score = torch.where(ok, score, torch.full_like(score, -1.0))
    best = int(torch.argmax(score))  # the first best, as `score > best_score`
    if float(score[best]) < 0:
        return None
    inliers = torch.abs(points @ n[best] + d[best]) < threshold
    return best, n[best], d[best], inliers


def fit_ground_plane_ransac(
    points: np.ndarray,
    rng: np.random.Generator,
    iterations: int = 500,
    threshold_frac: float = 0.005,
    min_axis_component: float = 0.85,
    camera_centers: Optional[np.ndarray] = None,
    device=None,
):
    """Returns (normal, d, inlier_mask) for plane n.x + d = 0, or None; the
    scoring runs on `device` (CUDA unless the CPU is asked for)."""
    pts = torch.as_tensor(np.asarray(points, np.float64), device=resolve_device(device))
    fit = best_plane(pts, rng, iterations, threshold_frac, min_axis_component,
                     camera_centers)
    if fit is None:
        return None
    _, n, d, inliers = fit
    return n.cpu().numpy(), float(d), inliers.cpu().numpy()


def estimate_scale_from_tripod(
    points: np.ndarray,
    camtoworlds: np.ndarray,
    tripod_height_m: float,
    seed: int = 0,
    device=None,
) -> Dict:
    """points (N,3); camtoworlds (C,4,4). Returns the measurement JSON dict;
    the plane RANSAC and the percentiles run on `device` (CUDA unless the CPU
    is asked for)."""
    rng = np.random.default_rng(seed)
    centers = np.asarray(camtoworlds, np.float64)[:, :3, 3]
    pts = torch.as_tensor(np.asarray(points, np.float64), device=resolve_device(device))
    fit = best_plane(pts, rng, camera_centers=centers)
    if fit is None or tripod_height_m <= 0:
        return {
            "referenceType": "tripod",
            "valid": False,
            "reason": "no ground plane found or tripod height not set",
        }
    _, n_t, d_t, inliers = fit
    n, d = n_t.cpu().numpy(), float(d_t)
    heights = centers @ n + d
    # orient normal so cameras are above the plane
    if np.median(heights) < 0:
        n, d, heights = -n, -d, -heights
    median_height = float(np.median(heights))
    if median_height <= 1e-9:
        return {"referenceType": "tripod", "valid": False, "reason": "degenerate height"}
    scale = tripod_height_m / median_height

    cv = float(np.std(heights) / max(np.median(heights), 1e-9))
    confidence = "high" if cv < 0.05 else ("medium" if cv < 0.15 else "low")

    lo, hi = quantile(pts, 0.02).cpu().numpy(), quantile(pts, 0.98).cpu().numpy()
    dims = (hi - lo) * scale
    return {
        "referenceType": "tripod",
        "valid": True,
        "tripodHeightM": tripod_height_m,
        "metersPerModelUnit": float(scale),
        "confidence": confidence,
        "heightCV": cv,
        "groundPlane": {"normal": n.tolist(), "d": float(d)},
        "numPlaneInliers": int(inliers.sum()),
        "boundingBoxDimsM": {
            "x": float(dims[0]), "y": float(dims[1]), "z": float(dims[2])
        },
    }
