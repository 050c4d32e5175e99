"""Splat training parameters: fixed-capacity tensors + alive mask (the port of
tpu_splat/gs/params.py). Densify/prune move gaussians between slots; capacity
grows geometrically when occupancy crosses a threshold."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.core.types import SH_DIM_FOR_DEGREE, GaussianCloud, to_numpy
from tpu_splat_torch.gs.sh import SH_C0

Params = Dict[str, torch.Tensor]  # means, scales, quats, opacities, sh0, shN, alive


def knn_mean_dist(points: np.ndarray, k: int = 3, chunk: int = 2048) -> np.ndarray:
    """Mean distance to the k nearest neighbors (excluding self), chunked O(N^2)."""
    n = points.shape[0]
    out = np.empty(n, np.float32)
    for i in range(0, n, chunk):
        d2 = np.sum((points[i : i + chunk, None] - points[None]) ** 2, axis=-1)
        np.fill_diagonal(d2[:, i : i + chunk], np.inf)
        kk = min(k, n - 1)
        nearest = np.partition(d2, kk - 1, axis=1)[:, :kk]
        out[i : i + chunk] = np.sqrt(np.maximum(nearest, 1e-12)).mean(axis=1)
    return out


def init_params_from_points(
    points: np.ndarray,
    colors: np.ndarray,
    capacity: int,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    device=None,
) -> Params:
    """Standard 3DGS initialisation from an SfM sparse cloud.

    points (P, 3); colors (P, 3) in [0, 1]. Capacity >= P; remaining slots dead.
    """
    dev = resolve_device(device)
    p = points.shape[0]
    if capacity < p:
        raise ValueError(f"capacity {capacity} < {p} points")
    k = SH_DIM_FOR_DEGREE[sh_degree]

    dist = np.clip(knn_mean_dist(points), 1e-7, None)
    means = np.zeros((capacity, 3), np.float32)
    means[:p] = points
    scales = np.zeros((capacity, 3), np.float32)
    scales[:p] = np.log(dist)[:, None]
    quats = np.zeros((capacity, 4), np.float32)
    quats[:, 0] = 1.0
    opac = np.full((capacity,), float(np.log(init_opacity / (1 - init_opacity))), np.float32)
    sh0 = np.zeros((capacity, 3), np.float32)
    sh0[:p] = (np.clip(colors, 0, 1) - 0.5) / SH_C0
    shn = np.zeros((capacity, k, 3), np.float32)
    alive = np.zeros((capacity,), bool)
    alive[:p] = True
    arrays = {"means": means, "scales": scales, "quats": quats, "opacities": opac,
              "sh0": sh0, "shN": shn, "alive": alive}
    return {name: torch.from_numpy(a).to(dev) for name, a in arrays.items()}


def params_to_cloud(params: Params) -> GaussianCloud:
    """Extract alive gaussians into an interchange GaussianCloud (host numpy)."""
    idx = np.nonzero(to_numpy(params["alive"]))[0]
    return GaussianCloud(
        means=to_numpy(params["means"])[idx],
        scales=to_numpy(params["scales"])[idx],
        quats=to_numpy(params["quats"])[idx],
        opacities=to_numpy(params["opacities"])[idx],
        sh0=to_numpy(params["sh0"])[idx],
        shN=to_numpy(params["shN"])[idx],
    )


def grow_tree(tree: Dict[str, torch.Tensor], new_capacity: int) -> Dict[str, torch.Tensor]:
    """Pad every tensor of a dict along axis 0 with zeros to the new capacity."""
    out = {}
    for name, arr in tree.items():
        pad = arr.new_zeros((new_capacity - arr.shape[0],) + tuple(arr.shape[1:]))
        out[name] = torch.cat([arr, pad], dim=0)
    return out


def grow_capacity(params: Params, new_capacity: int) -> Params:
    """Pad all parameters to a larger capacity (new slots dead, unit quats)."""
    if new_capacity <= params["means"].shape[0]:
        return params
    out = grow_tree(params, new_capacity)
    cap = params["means"].shape[0]
    out["quats"][cap:, 0] = 1.0
    return out


def num_alive(params: Params) -> int:
    return int(params["alive"].sum().item())
