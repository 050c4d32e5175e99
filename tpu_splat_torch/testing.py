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


# Pair counts for build_packed's 12-tile fixture that put a tile on each edge
# of the backward's sweep: empty, one pair, both sides of a 16-gaussian
# segment and of a 128-gaussian chunk, and one short of K = 256.
RAGGED_COUNTS = (0, 1, 15, 16, 17, 127, 128, 129, 255, 256, 64, 200)


def build_packed(rng: np.random.Generator, t_total: int, k: int, width_tiles: int,
                 tile_size: int = 16, counts=None):
    """Packed (16, T, K) f32 tensor and (T,) int32 pair counts with mixed
    regimes per tile (the numpy twin of scripts/check_kernel_parity.py's):
    tile 1 near-empty (4 pairs), tile 2 saturating in its first chunk, tile 3
    never saturating, the rest mid-opacity. `counts` (T,) overrides the pair
    counts (K each, 4 for tile 1); the slots past a tile's count stay the
    zero sentinel row."""
    feat = np.zeros((16, t_total, k), np.float32)
    if counts is None:
        counts = [4 if t == 1 else k for t in range(t_total)]
    for t in range(t_total):
        tx0 = (t % width_tiles) * tile_size
        ty0 = (t // width_tiles) * tile_size
        n_g = int(counts[t])
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
    return feat, np.asarray(counts, np.int32)


def walk_viewmats(n_views: int, span: float = 5.0, depth: float = 4.2) -> np.ndarray:
    """(n_views, 4, 4) world-to-camera matrices of a forward-facing lateral
    walk: the eye slides along x at z = -depth, looking at (0, 0.3, 0)."""
    mats = []
    for x in np.linspace(-span / 2, span / 2, n_views):
        eye = np.array([x, 0.3, -depth])
        z = np.array([0.0, 0.3, 0.0]) - eye
        z /= np.linalg.norm(z)
        xax = np.cross(np.array([0.0, -1.0, 0.0]), z)
        xax /= np.linalg.norm(xax)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.stack([xax, np.cross(z, xax), z])
        m[:3, 3] = -m[:3, :3] @ eye
        mats.append(m)
    return np.stack(mats)


def textured_scene(rng: np.random.Generator, n_rock: int = 20_000, n_plane: int = 40_000,
                   n_wall: int = 40_000, sizes: tuple = (0.01, 0.06), bimodal: bool = False):
    """A textured scene for SfM as numpy gaussian parameters (means,
    log-scales, quats, opacity logits, sh0, shN): a bumpy 'rock' on a ground
    plane (+y down) before a back wall, made of blobs whose sizes are
    log-uniform in `sizes` (metres) and whose colours are uniform, or, with
    `bimodal`, dark or light with a little jitter. The defaults are
    chip_smoke.py's phase-6 scene: texture distinctive at every scale."""
    dirs = rng.normal(size=(n_rock, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radius = (1.0 + 0.25 * np.sin(5 * dirs[:, 0]) * np.cos(4 * dirs[:, 1])
              + 0.05 * rng.normal(size=n_rock))
    means = np.concatenate([
        dirs * radius[:, None],
        np.stack([rng.uniform(-3, 3, n_plane),
                  np.full(n_plane, 1.3) + rng.normal(0, 0.02, n_plane),
                  rng.uniform(-3, 3, n_plane)], axis=1),
        np.stack([rng.uniform(-6, 6, n_wall), rng.uniform(-3, 1.3, n_wall),
                  np.full(n_wall, 3.5) + rng.normal(0, 0.02, n_wall)], axis=1)])
    n = len(means)
    log_s = rng.uniform(np.log(sizes[0]), np.log(sizes[1]), (n, 1))
    if bimodal:
        colors = np.clip(rng.choice([0.1, 0.9], size=(n, 1))
                         + rng.uniform(-0.1, 0.1, (n, 3)), 0, 1)
    else:
        colors = rng.uniform(0, 1, (n, 3))
    return [means.astype(np.float32), np.repeat(log_s, 3, 1).astype(np.float32),
            np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)),
            np.full((n,), 4.0, np.float32), ((colors - 0.5) / 0.2820948).astype(np.float32),
            np.zeros((n, 0, 3), np.float32)]


def render_capture(scene, viewmats: np.ndarray, focal: float, width: int, height: int,
                   background: float = 0.7, max_per_tile: int = 256, device="cpu") -> np.ndarray:
    """(V, H, W, 3) f32 images of `textured_scene` parameters rendered by the
    port from each world-to-camera matrix, principal point at the centre."""
    import torch

    from tpu_splat_torch.gs.render import render_view

    with torch.no_grad():
        params = [torch.from_numpy(a).to(device) for a in scene]
        bg = torch.full((3,), background, device=device)
        return np.stack([
            render_view(*params, torch.from_numpy(vm).to(device), focal, focal, width / 2,
                        height / 2, width, height, sh_degree=0, background=bg,
                        max_per_tile=max_per_tile, device=device).color.cpu().numpy()
            for vm in viewmats])


def centre_rmse(scene, viewmats: np.ndarray) -> float:
    """RMSE, in world units, of an SfMScene's registered camera centres
    against the true ones (world-to-camera `viewmats`, one per input image)
    after a similarity alignment."""
    import torch

    from tpu_splat_torch.sfm.geometry import umeyama_alignment

    reg = np.asarray(scene.registered)
    gt = np.stack([-vm[:3, :3].T @ vm[:3, 3] for vm in viewmats])[reg].astype(np.float32)
    rec = np.asarray(scene.cameras.camtoworlds)[:, :3, 3].astype(np.float32)
    s, R, t = umeyama_alignment(torch.from_numpy(rec), torch.from_numpy(gt))
    aligned = float(s) * rec @ R.numpy().T + t.numpy()
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))
