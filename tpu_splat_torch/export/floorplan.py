"""Floorplan extraction from a splat point cloud (the port of
tpu_splat/export/floorplan.py).

The reference's extract_floorplan.py semantics: RANSAC floor plane (700
iterations) -> project inliers to the plane basis -> rasterize to a <=768px
occupancy grid -> dilate/erode/median clean-up -> largest contour ->
approxPolyDP polygon; minAreaRect fallback. Outputs an annotated SVG (wall
lengths, scale bar), a PNG, a GeoJSON polygon, and metadata JSON with a density
quality classification.

The plane fit, the projections and the grid indices run on the device in
f64; cv2's morphology, contours and polygon fit stay on the host, and the
writers are the reference's.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.export.measurement import best_plane


def _plane_basis(normal: np.ndarray):
    a = np.array([1.0, 0, 0]) if abs(normal[0]) < 0.9 else np.array([0.0, 1, 0])
    u = np.cross(normal, a)
    u /= np.linalg.norm(u)
    v = np.cross(normal, u)
    return u, v


def project_to_plane(pts: torch.Tensor, u: np.ndarray, v: np.ndarray) -> torch.Tensor:
    """(N, 3) f64 points -> (N, 2) coordinates in the plane basis (u, v)."""
    return torch.stack([pts @ torch.as_tensor(u, device=pts.device),
                        pts @ torch.as_tensor(v, device=pts.device)], dim=1)


def occupancy_grid(pts2d: torch.Tensor, grid_max: int):
    """Rasterize (N, 2) plane coordinates into a uint8 occupancy grid with an
    8-pixel border, at (grid_max - 16) pixels over the larger extent. Returns
    (grid (H, W) uint8 numpy, lo (2,), scale)."""
    lo_t = pts2d.min(0).values
    lo = lo_t.cpu().numpy()
    extent = np.maximum(pts2d.max(0).values.cpu().numpy() - lo, 1e-9)
    scale = (grid_max - 16) / extent.max()
    size = np.ceil(extent * scale).astype(int) + 16
    ij = ((pts2d - lo_t) * scale + 8).to(torch.int64)
    ij[:, 0].clamp_(0, int(size[0]) - 1)
    ij[:, 1].clamp_(0, int(size[1]) - 1)
    grid = torch.zeros((int(size[1]), int(size[0])), dtype=torch.uint8, device=pts2d.device)
    grid[ij[:, 1], ij[:, 0]] = 255
    return grid.cpu().numpy(), lo, scale


def _points_to_polygon(pts2d: torch.Tensor, grid_max: int = 768):
    """Rasterize 2D points -> occupancy -> cleaned mask -> largest polygon.

    Grid resolution adapts to point density (sparse clouds get a coarse grid so
    dilation can connect the occupancy; capped at grid_max for dense clouds)."""
    import cv2

    grid_max = int(np.clip(2.0 * np.sqrt(len(pts2d)), 64, grid_max))
    grid, lo, scale = occupancy_grid(pts2d, grid_max)

    k = np.ones((5, 5), np.uint8)
    mask = cv2.dilate(grid, k, iterations=3)
    mask = cv2.erode(mask, k, iterations=2)
    mask = cv2.medianBlur(mask, 5)

    contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return None, (lo, scale)
    largest = max(contours, key=cv2.contourArea)
    if cv2.contourArea(largest) < 25:
        return None, (lo, scale)
    eps = 0.01 * cv2.arcLength(largest, True)
    poly = cv2.approxPolyDP(largest, eps, True)[:, 0, :]
    if len(poly) < 3:
        rect = cv2.minAreaRect(largest)
        poly = cv2.boxPoints(rect)
    # back to plane coordinates
    poly_plane = (poly - 8) / scale + lo
    return poly_plane, (lo, scale)


def _polygon_to_svg(poly_m: np.ndarray, path: str, scale_m_per_unit: float):
    lo = poly_m.min(0)
    hi = poly_m.max(0)
    extent = np.maximum(hi - lo, 1e-9)
    size = 800
    s = (size - 80) / extent.max()
    pts = (poly_m - lo) * s + 40

    lines = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}" '
        f'viewBox="0 0 {size} {size}">',
        '<rect width="100%" height="100%" fill="white"/>',
        '<polygon points="'
        + " ".join(f"{p[0]:.1f},{p[1]:.1f}" for p in pts)
        + '" fill="#e8eef7" stroke="#1a3a5c" stroke-width="3"/>',
    ]
    # wall length labels
    n = len(poly_m)
    for i in range(n):
        a, b = poly_m[i], poly_m[(i + 1) % n]
        mid = ((pts[i] + pts[(i + 1) % n]) / 2)
        length = np.linalg.norm(b - a)
        lines.append(
            f'<text x="{mid[0]:.0f}" y="{mid[1]:.0f}" font-size="14" '
            f'fill="#333" text-anchor="middle">{length:.2f} m</text>'
        )
    # scale bar: 1 meter
    bar = 1.0 * s
    lines.append(
        f'<line x1="40" y1="{size-30}" x2="{40+bar:.0f}" y2="{size-30}" '
        f'stroke="black" stroke-width="3"/>'
    )
    lines.append(
        f'<text x="{40+bar/2:.0f}" y="{size-38}" font-size="13" '
        f'text-anchor="middle">1 m</text>'
    )
    lines.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _polygon_to_png(poly_m: np.ndarray, path: str):
    import cv2

    lo = poly_m.min(0)
    extent = np.maximum(poly_m.max(0) - lo, 1e-9)
    size = 800
    s = (size - 80) / extent.max()
    img = np.full((size, size, 3), 255, np.uint8)
    pts = ((poly_m - lo) * s + 40).astype(np.int32)
    cv2.fillPoly(img, [pts], (247, 238, 232))
    cv2.polylines(img, [pts], True, (92, 58, 26), 3)
    cv2.imwrite(path, img)


def extract_floorplan(
    points: np.ndarray,
    scale_m_per_unit: float = 1.0,
    out_dir: str = ".",
    seed: int = 0,
    device=None,
) -> Dict[str, str]:
    """Returns artifact name -> path for floorplan.{svg,png,geojson,json}; the
    plane fit and the projections run on `device` (CUDA unless the CPU is
    asked for)."""
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(np.asarray(points, np.float64), device=resolve_device(device))
    fit = best_plane(pts, rng, iterations=700)
    os.makedirs(out_dir, exist_ok=True)
    meta_path = os.path.join(out_dir, "floorplan.json")
    if fit is None:
        with open(meta_path, "w") as f:
            json.dump({"valid": False, "reason": "no floor plane"}, f)
        return {"floorplan_meta": meta_path}
    _, n_t, _, inliers_t = fit
    n = n_t.cpu().numpy()
    n_inliers = int(inliers_t.sum())
    u, v = _plane_basis(n)
    pts2d = project_to_plane(pts[inliers_t], u, v)

    poly, _ = _points_to_polygon(pts2d)
    density = n_inliers / max(points.shape[0], 1)
    quality = "dense" if n_inliers > 20000 else (
        "normal" if n_inliers > 2000 else "sparse"
    )
    artifacts = {}
    if poly is not None:
        poly_m = poly * scale_m_per_unit
        svg_path = os.path.join(out_dir, "floorplan.svg")
        png_path = os.path.join(out_dir, "floorplan.png")
        geo_path = os.path.join(out_dir, "floorplan.geojson")
        _polygon_to_svg(poly_m, svg_path, scale_m_per_unit)
        _polygon_to_png(poly_m, png_path)
        ring = poly_m.tolist() + [poly_m[0].tolist()]
        with open(geo_path, "w") as f:
            json.dump(
                {
                    "type": "FeatureCollection",
                    "features": [{
                        "type": "Feature",
                        "properties": {"layer": "floorplan", "units": "meters"},
                        "geometry": {"type": "Polygon", "coordinates": [ring]},
                    }],
                },
                f,
            )
        area = 0.5 * abs(
            sum(
                poly_m[i][0] * poly_m[(i + 1) % len(poly_m)][1]
                - poly_m[(i + 1) % len(poly_m)][0] * poly_m[i][1]
                for i in range(len(poly_m))
            )
        )
        artifacts.update(
            floorplan_svg=svg_path, floorplan_png=png_path, floorplan_geojson=geo_path
        )
    else:
        area = 0.0
    with open(meta_path, "w") as f:
        json.dump(
            {
                "valid": poly is not None,
                "quality": quality,
                "floorInliers": n_inliers,
                "inlierFraction": float(density),
                "areaM2": float(area),
                "scaleMPerUnit": scale_m_per_unit,
                "planeNormal": n.tolist(),
            },
            f,
            indent=2,
        )
    artifacts["floorplan_meta"] = meta_path
    return artifacts
