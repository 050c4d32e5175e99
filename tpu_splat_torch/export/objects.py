"""Semantic object layer: per-object footprints above the floor plane (the
port of tpu_splat/export/objects.py).

The reference's extract_object_layer.py semantics: take points in a height band
above the fitted floor plane (0.06-2.8 m), project to the plane, rasterize,
connected components, per-object polygons with footprint areas; emits GeoJSON +
an overlay SVG. Objects smaller than min_object_area_m2 are dropped.

The plane fit, the heights, the projections and the grid indices run on the
device in f64; cv2's morphology, components and contours stay on the host.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.export.floorplan import _plane_basis, occupancy_grid, project_to_plane
from tpu_splat_torch.export.measurement import best_plane, quantile


def extract_object_layer(
    points: np.ndarray,
    scale_m_per_unit: float = 1.0,
    min_object_area_m2: float = 0.25,
    height_band_m=(0.06, 2.8),
    out_dir: str = ".",
    seed: int = 0,
    device=None,
) -> Dict[str, str]:
    """Returns artifact name -> path for objects.{geojson,svg}; the plane fit
    and the projections run on `device` (CUDA unless the CPU is asked for)."""
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    geo_path = os.path.join(out_dir, "objects.geojson")
    svg_path = os.path.join(out_dir, "objects.svg")

    pts = torch.as_tensor(np.asarray(points, np.float64), device=resolve_device(device))
    fit = best_plane(pts, rng, iterations=700)
    if fit is None or scale_m_per_unit <= 0:
        with open(geo_path, "w") as f:
            json.dump({"type": "FeatureCollection", "features": []}, f)
        return {"objects_geojson": geo_path}
    _, n_t, d_t, _ = fit
    n, d = n_t.cpu().numpy(), float(d_t)
    heights = pts @ n_t + d_t
    if float(quantile(heights, 0.5)) < 0:
        n, d = -n, -d
        heights = -heights
    heights_m = heights * scale_m_per_unit
    band = (heights_m > height_band_m[0]) & (heights_m < height_band_m[1])
    obj_pts = pts[band]

    features = []
    if len(obj_pts) >= 20:
        u, v = _plane_basis(n)
        grid, lo, s = occupancy_grid(project_to_plane(obj_pts, u, v), 768)
        mask = cv2.dilate(grid, np.ones((5, 5), np.uint8), iterations=2)
        mask = cv2.erode(mask, np.ones((3, 3), np.uint8), iterations=1)
        n_comp, labels = cv2.connectedComponents(mask)
        for c in range(1, n_comp):
            comp = (labels == c).astype(np.uint8) * 255
            contours, _ = cv2.findContours(comp, cv2.RETR_EXTERNAL,
                                           cv2.CHAIN_APPROX_SIMPLE)
            if not contours:
                continue
            cont = max(contours, key=cv2.contourArea)
            eps = 0.02 * cv2.arcLength(cont, True)
            poly = cv2.approxPolyDP(cont, eps, True)[:, 0, :]
            if len(poly) < 3:
                continue
            poly_m = ((poly - 8) / s + lo) * scale_m_per_unit
            area = 0.5 * abs(
                sum(
                    poly_m[i][0] * poly_m[(i + 1) % len(poly_m)][1]
                    - poly_m[(i + 1) % len(poly_m)][0] * poly_m[i][1]
                    for i in range(len(poly_m))
                )
            )
            if area < min_object_area_m2:
                continue
            ring = poly_m.tolist() + [poly_m[0].tolist()]
            features.append({
                "type": "Feature",
                "properties": {"layer": "object", "footprintAreaM2": float(area)},
                "geometry": {"type": "Polygon", "coordinates": [ring]},
            })

    with open(geo_path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": features}, f, indent=2)

    # overlay SVG
    lines = ['<svg xmlns="http://www.w3.org/2000/svg" width="800" height="800" '
             'viewBox="0 0 800 800">',
             '<rect width="100%" height="100%" fill="white"/>']
    if features:
        all_pts = np.concatenate(
            [np.array(fe["geometry"]["coordinates"][0]) for fe in features]
        )
        lo2 = all_pts.min(0)
        ext2 = np.maximum(all_pts.max(0) - lo2, 1e-9)
        sc = 720 / ext2.max()
        for fe in features:
            ring = (np.array(fe["geometry"]["coordinates"][0]) - lo2) * sc + 40
            lines.append(
                '<polygon points="'
                + " ".join(f"{p[0]:.1f},{p[1]:.1f}" for p in ring)
                + '" fill="#f7e8e8" stroke="#8a2a2a" stroke-width="2"/>'
            )
    lines.append("</svg>")
    with open(svg_path, "w") as f:
        f.write("\n".join(lines))
    return {"objects_geojson": geo_path, "objects_svg": svg_path}
