"""The inputs of a cell, made on the device from the seed.

A "truth" cloud drawn in the traffic's box, its sizes and opacities drawn
from the rows of a trained splat (`traffic/sizes/<name>.csv`, written by
`splatbench.tools.job_sizes` from the program's own training of a capture),
training views on a horizontal
camera ring around (or inside) it, their target images rendered from the
truth cloud by the benchmark's own plain renderer, and the cloud to train:
the truth cloud with seeded perturbations of means, scales, opacities and
colours, so that gradients and densification behave as in a job partway
through its training. The same seed gives the same tensors.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple

import numpy as np
import torch

from splatbench.reference import render as R

LEAVES = ("means", "scales", "quats", "opacities", "sh0", "shN")
SIZES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traffic", "sizes")


def size_rows(name: str) -> np.ndarray:
    """(R, 4) rows of a trained splat: three log-scales in pixels at its
    cameras' orbit radius, and the opacity logit."""
    rows = np.loadtxt(os.path.join(SIZES_DIR, f"{name}.csv"), delimiter=",", skiprows=1,
                      dtype=np.float32)
    if rows.ndim != 2 or rows.shape[1] != 4:
        raise ValueError(f"sizes {name!r}: rows of 4 numbers expected, not {rows.shape}")
    return rows


class Scene(NamedTuple):
    truth: Dict[str, torch.Tensor]
    params: Dict[str, torch.Tensor]  # the cloud to train, "alive" included
    viewmats: torch.Tensor           # (V, 4, 4) world-to-camera
    intrinsics: np.ndarray           # (V, 4) fx fy cx cy, float32
    images: torch.Tensor             # (V, H, W, 3) targets in [0, 1]
    scene_scale: float


def look_at(eye: np.ndarray) -> np.ndarray:
    """World-to-camera (4, 4) for a camera at `eye` looking at the origin
    (+z forward, -y up)."""
    z = -eye / np.linalg.norm(eye)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.stack([x, np.cross(z, x), z])
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def ring_viewmats(n_views: int, radius: float, height: float) -> np.ndarray:
    """(n_views, 4, 4) cameras evenly spaced on a horizontal ring."""
    return np.stack([look_at(np.array([radius * np.cos(a), height, radius * np.sin(a)]))
                     for a in np.linspace(0, 2 * np.pi, n_views, endpoint=False)])


def draw_cloud(tr: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every slot drawn: means uniform in the box; log-scales and opacity
    logit together from a row of the traffic's `sizes`, drawn with
    replacement, the scales taken from pixels at the trained splat's orbit
    radius to world units at this ring's radius and focal; quaternions
    (1, q N(0, 1)^3); DC colour and higher SH normal. The first `alive`
    slots live."""
    cap, n_sh = tr["capacity"], (tr["sh_degree"] + 1) ** 2 - 1
    rows = torch.from_numpy(size_rows(tr["sizes"])).to(device)
    row = rows[torch.randint(rows.shape[0], (cap,), generator=gen, device=device)]
    px_to_world = float(np.log(tr["ring_radius"] / (tr["focal_scale"] * tr["width"])))

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def n(*shape):
        return torch.randn(shape, generator=gen, device=device)

    box = torch.tensor(tr["box_half_widths"], dtype=torch.float32, device=device)
    return {
        "means": (2.0 * u(cap, 3) - 1.0) * box,
        "scales": row[:, :3] + px_to_world,
        "quats": torch.cat([torch.ones((cap, 1), device=device),
                            tr["quat_noise"] * n(cap, 3)], dim=1),
        "opacities": row[:, 3].contiguous(),
        "sh0": tr["sh0_std"] * n(cap, 3),
        "shN": tr["shN_std"] * n(cap, n_sh, 3),
        "alive": torch.arange(cap, device=device) < tr["alive"],
    }


@torch.no_grad()
def make_scene(tr: dict, k_tile: int, seed: int, device) -> Scene:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    truth = draw_cloud(tr, gen, device)
    params = dict(truth)
    for k, sigma in tr["perturb"].items():
        params[k] = truth[k] + sigma * torch.randn(truth[k].shape, generator=gen,
                                                   device=device)
    w, h = tr["width"], tr["height"]
    viewmats = torch.from_numpy(ring_viewmats(tr["views"], tr["ring_radius"],
                                              tr["ring_height"])).to(device)
    f = tr["focal_scale"] * w
    intrinsics = np.tile(np.array([[f, f, w / 2, h / 2]], np.float32), (tr["views"], 1))
    bg = torch.tensor(tr["target_background"], dtype=torch.float32, device=device)
    images = torch.empty((tr["views"], h, w, 3), device=device)
    for v in range(tr["views"]):
        out = R.render(*(truth[k] for k in LEAVES), viewmats[v], intrinsics[v], w, h,
                       tr["sh_degree"], k_tile, background=bg, alive=truth["alive"])
        images[v] = torch.clamp(out.color, 0.0, 1.0)
    # the job's scene scale: 1.1 x the mean distance of the points from their centroid
    pts = truth["means"][truth["alive"]]
    scene_scale = 1.1 * float(torch.linalg.norm(pts - pts.mean(0), dim=1).mean())
    return Scene(truth, params, viewmats, intrinsics, images, scene_scale)
