"""Densification / pruning for 3DGS training (the port of tpu_splat/gs/strategy.py).

Array ops over fixed-capacity slot tensors: split/duplicate targets are
allocated into dead slots with a cumsum rank + scatter. Defaults follow
gsplat/splatfacto: refine every 100 steps in [500, 15000), screen-gradient
threshold 2e-4 (NDC), split above 1% of the scene extent, prune below opacity
0.005, opacity reset every 3000 steps. Split offsets are drawn from a
torch.Generator (the reference draws from jax.random, so the two differ).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from tpu_splat_torch.gs.optim import AdamState, reset_slots
from tpu_splat_torch.gs.projection import quat_to_rotmat

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class DensifyConfig:
    refine_start: int = 500
    refine_stop: int = 15000
    refine_every: int = 100
    grad_threshold: float = 0.0002  # NDC-units screen gradient
    split_scale_threshold: float = 0.01  # x scene_scale: bigger -> split, else duplicate
    prune_opacity: float = 0.005
    prune_scale3d: float = 0.1  # x scene_scale: prune world-space giants
    reset_opacity_every: int = 3000
    reset_opacity_value: float = 0.01
    split_factor: float = 1.6


class DensifyState(NamedTuple):
    grad_accum: torch.Tensor  # (N,) accumulated NDC gradient norms
    count_accum: torch.Tensor  # (N,) number of steps each gaussian was visible


def densify_state_init(capacity: int, device) -> DensifyState:
    return DensifyState(
        grad_accum=torch.zeros((capacity,), dtype=torch.float32, device=device),
        count_accum=torch.zeros((capacity,), dtype=torch.float32, device=device),
    )


def accumulate_gradients(state: DensifyState, means2d_grad: torch.Tensor,
                         radii: torch.Tensor, width: int, height: int) -> DensifyState:
    """Accumulate screen-space gradient norms (converted to NDC units)."""
    g = torch.stack([means2d_grad[:, 0] * (width / 2.0),
                     means2d_grad[:, 1] * (height / 2.0)], dim=-1)
    norm = torch.linalg.norm(g, dim=-1)
    visible = radii > 0
    return DensifyState(
        grad_accum=state.grad_accum + torch.where(visible, norm, torch.zeros_like(norm)),
        count_accum=state.count_accum + visible.to(torch.float32),
    )


def _scatter_drop(arr: torch.Tensor, target: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """arr with rows `target` set to `vals`; target == len(arr) drops the row
    (written into one spare row that is sliced off)."""
    buf = torch.cat([arr, arr[:1]], dim=0)
    buf[target] = vals
    return buf[:-1]


@torch.no_grad()
def refine(
    params: Params,
    adam_state: AdamState,
    dstate: DensifyState,
    generator: torch.Generator,
    scene_scale: float,
    cfg: DensifyConfig,
    step: int = 0,
) -> Tuple[Params, AdamState, DensifyState, Dict[str, torch.Tensor]]:
    """One densify+prune pass. Returns updated (params, adam, dstate, stats)."""
    capacity = params["means"].shape[0]
    alive = params["alive"]

    avg_grad = dstate.grad_accum / torch.clamp_min(dstate.count_accum, 1.0)
    seen = dstate.count_accum > 0
    candidate = alive & seen & (avg_grad > cfg.grad_threshold)

    scale_max = torch.exp(params["scales"].amax(dim=-1))
    is_split = candidate & (scale_max > cfg.split_scale_threshold * scene_scale)
    is_dup = candidate & ~is_split

    # prune transparent gaussians always; world-space giants only after the
    # first opacity reset
    opac = torch.sigmoid(params["opacities"])
    prune_big = (scale_max > cfg.prune_scale3d * scene_scale) & (step > cfg.reset_opacity_every)
    prune = alive & ((opac < cfg.prune_opacity) | prune_big)
    is_split = is_split & ~prune
    is_dup = is_dup & ~prune
    alive = alive & ~prune

    # each split or dup requests one dead slot; dead slots in index order
    # (a stable argsort, as JAX's argsort is)
    request = is_split | is_dup
    rank = torch.cumsum(request.to(torch.int64), 0) - 1
    dead_sorted = torch.argsort(alive.to(torch.int32), stable=True)
    n_dead = (~alive).sum()
    granted = request & (rank < n_dead)
    target = torch.where(granted, dead_sorted[torch.clamp(rank, 0, capacity - 1)],
                         torch.full_like(rank, capacity))

    # splits resample both the in-place parent and the new child inside the
    # parent gaussian, with scales shrunk by split_factor
    R = quat_to_rotmat(params["quats"])
    std = torch.exp(params["scales"])

    def sample_offset():
        local = torch.randn((capacity, 3), generator=generator,
                            device=std.device) * std
        return torch.einsum("nij,nj->ni", R, local)

    split_scales = params["scales"] - math.log(cfg.split_factor)
    split_col = is_split[:, None]
    child = {
        "means": torch.where(split_col, params["means"] + sample_offset(), params["means"]),
        "scales": torch.where(split_col, split_scales, params["scales"]),
        "quats": params["quats"],
        "opacities": params["opacities"],
        "sh0": params["sh0"],
        "shN": params["shN"],
    }
    new_params = dict(params)
    new_params["means"] = torch.where(split_col, params["means"] + sample_offset(),
                                      params["means"])
    new_params["scales"] = torch.where(split_col, split_scales, params["scales"])
    for name, vals in child.items():
        new_params[name] = _scatter_drop(new_params[name], target, vals)
    new_alive = _scatter_drop(alive, target, granted)
    new_params["alive"] = new_alive

    # reset optimizer moments for split parents, new slots and pruned slots
    moved = _scatter_drop(torch.zeros_like(alive), target, granted)
    adam_state = reset_slots(adam_state, moved | is_split | prune)

    stats = {
        "n_split": (is_split & granted).sum(),
        "n_dup": (is_dup & granted).sum(),
        "n_pruned": prune.sum(),
        "n_alive": new_alive.sum(),
    }
    return new_params, adam_state, densify_state_init(capacity, std.device), stats


@torch.no_grad()
def reset_opacity(params: Params, adam_state: AdamState,
                  value: float = 0.01) -> Tuple[Params, AdamState]:
    """Clamp opacities to at most `value` (probability space) and clear the
    opacity moments: the periodic opacity reset of the default strategy."""
    logit = float(np.log(np.float32(value / (1.0 - value))))  # f32, as the reference
    new = dict(params)
    new["opacities"] = torch.clamp_max(params["opacities"], logit)
    mu = dict(adam_state.mu)
    nu = dict(adam_state.nu)
    mu["opacities"] = torch.zeros_like(mu["opacities"])
    nu["opacities"] = torch.zeros_like(nu["opacities"])
    return new, AdamState(mu=mu, nu=nu, count=adam_state.count)
