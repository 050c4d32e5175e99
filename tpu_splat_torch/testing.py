"""Seeded synthetic inputs for checking the port: a ring of cameras, a capture
of a ground-truth cloud rendered by the port, and the mixed-regime packed
tensor of scripts/check_kernel_parity.py. Used by the tests, chip_smoke.py
and scripts/compare_torch_train_splat.py; numpy in, numpy out."""

from __future__ import annotations

import numpy as np


def look_at(eye: np.ndarray) -> np.ndarray:
    """World-to-camera (4, 4) f32 for a camera at `eye` looking at the origin
    (+z forward, -y up)."""
    z = -eye / np.linalg.norm(eye)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.stack([x, np.cross(z, x), z])
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def ring_viewmats(n_views: int, radius: float, height: float = 0.8) -> np.ndarray:
    """(n_views, 4, 4) cameras evenly spaced on a horizontal ring, as bench.py
    places them."""
    return np.stack([look_at(np.array([radius * np.cos(a), height, radius * np.sin(a)]))
                     for a in np.linspace(0, 2 * np.pi, n_views, endpoint=False)])


def synthetic_capture(n: int = 60, width: int = 64, height: int = 48, focal: float = 60.0,
                      n_views: int = 16, radius: float = 3.5, seed: int = 7,
                      scale: float = 0.12, max_per_tile: int = 128, device="cpu"):
    """A ring capture of n round gaussians (std `scale`) of random colour in
    [-1, 1]^3, rendered by the port on `device`, and a noisy copy of their
    centres as the sparse point cloud to train from.

    Returns (viewmats (V, 4, 4), intrinsics (V, 4), images (V, H, W, 3),
    points (n, 3), point colours (n, 3)), all numpy f32."""
    import torch

    from tpu_splat_torch.gs.render import render_view

    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    gt = [means, np.full((n, 3), np.log(scale), np.float32),
          np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)),
          np.full((n,), 2.0, np.float32),
          ((rng.uniform(0, 1, (n, 3)) - 0.5) / 0.2820948).astype(np.float32),
          np.zeros((n, 0, 3), np.float32)]
    viewmats = ring_viewmats(n_views, radius)
    with torch.no_grad():
        gt_d = [torch.from_numpy(a).to(device) for a in gt]
        images = np.stack([
            render_view(*gt_d, torch.from_numpy(vm).to(device), focal, focal, width / 2,
                        height / 2, width, height, sh_degree=0,
                        background=torch.zeros(3, device=device), max_per_tile=max_per_tile,
                        device=device).color.cpu().numpy()
            for vm in viewmats])
    intrin = np.tile(np.array([[focal, focal, width / 2, height / 2]], np.float32),
                     (n_views, 1))
    pts = (means + rng.normal(0, 0.1, means.shape)).astype(np.float32)
    colors = rng.uniform(0.3, 0.7, (n, 3)).astype(np.float32)
    return viewmats, intrin, images, pts, colors


def build_packed(rng: np.random.Generator, t_total: int, k: int, width_tiles: int,
                 tile_size: int = 16):
    """Packed (16, T, K) f32 tensor and (T,) int32 pair counts with mixed
    regimes per tile (the numpy twin of scripts/check_kernel_parity.py's):
    tile 1 near-empty (4 pairs), tile 2 saturating in its first chunk, tile 3
    never saturating, the rest mid-opacity."""
    feat = np.zeros((16, t_total, k), np.float32)
    counts = []
    for t in range(t_total):
        tx0 = (t % width_tiles) * tile_size
        ty0 = (t // width_tiles) * tile_size
        n_g = 4 if t == 1 else k
        mx = tx0 + rng.uniform(-2, tile_size + 2, n_g)
        my = ty0 + rng.uniform(-2, tile_size + 2, n_g)
        if t == 2:
            op = rng.uniform(0.9, 0.999, n_g)
            scale = rng.uniform(1.5, 2.5, n_g)
        elif t == 3:
            op = rng.uniform(0.002, 0.01, n_g)
            scale = rng.uniform(2.0, 6.0, n_g)
        else:
            op = rng.uniform(0.05, 0.9, n_g)
            scale = rng.uniform(1.0, 6.0, n_g)
        ca = 1.0 / scale**2
        cc = 1.0 / (scale * rng.uniform(0.5, 1.5, n_g)) ** 2
        cb = rng.uniform(-0.2, 0.2, n_g) * np.sqrt(ca * cc)
        feat[0, t, :n_g] = mx
        feat[1, t, :n_g] = my
        feat[2, t, :n_g] = ca
        feat[3, t, :n_g] = cb
        feat[4, t, :n_g] = cc
        feat[5:8, t, :n_g] = rng.uniform(0, 1, (3, n_g))
        feat[8, t, :n_g] = op
        feat[9, t, :n_g] = rng.uniform(0.5, 8.0, n_g)
        counts.append(n_g)
    return feat, np.asarray(counts, np.int32)
