"""MCMC densification strategy (3DGS-as-MCMC), the splatfacto-mcmc analog
(the port of tpu_splat/gs/mcmc.py). Dead (transparent) gaussians are relocated
onto samples drawn from the live population with probability proportional to
opacity, and means get opacity-gated, covariance-shaped exploration noise.
Draws come from a torch.Generator."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from tpu_splat_torch.gs.optim import AdamState, reset_slots
from tpu_splat_torch.gs.projection import quat_to_rotmat

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class MCMCConfig:
    min_opacity: float = 0.005
    noise_lr: float = 5e5  # noise scale multiplier (gsplat default)
    grow_fraction: float = 0.05  # fraction of capacity to activate per refine


@torch.no_grad()
def add_noise(params: Params, generator: torch.Generator, lr_means: float,
              cfg: MCMCConfig) -> Params:
    """Add opacity-gated, covariance-shaped positional noise (exploration term)."""
    op = torch.sigmoid(params["opacities"])
    gate = torch.sigmoid(-100.0 * (op - cfg.min_opacity * 2))
    R = quat_to_rotmat(params["quats"])
    std = torch.exp(params["scales"])
    eps = torch.randn(params["means"].shape, generator=generator,
                      device=params["means"].device)
    noise = torch.einsum("nij,nj->ni", R, eps * std)
    noise = noise * (gate * cfg.noise_lr * lr_means)[:, None]
    noise = torch.where(params["alive"][:, None], noise, torch.zeros_like(noise))
    return {**params, "means": params["means"] + noise}


@torch.no_grad()
def relocate_and_grow(params: Params, adam_state: AdamState, generator: torch.Generator,
                      cfg: MCMCConfig) -> Tuple[Params, AdamState]:
    """Relocate transparent gaussians onto samples from the live population, and
    activate a budgeted number of dead capacity slots the same way."""
    capacity = params["means"].shape[0]
    alive = params["alive"]
    op = torch.sigmoid(params["opacities"])

    transparent = alive & (op < cfg.min_opacity)
    grow_budget = int(capacity * cfg.grow_fraction)
    dead = ~alive
    dead_rank = torch.cumsum(dead.to(torch.int64), 0) - 1
    grow = dead & (dead_rank < grow_budget)
    target = transparent | grow

    # sources: live gaussians with probability ~ opacity (uniform when no live
    # gaussian carries weight, so the draw never fails)
    probs = torch.where(alive & ~transparent, op, torch.zeros_like(op))
    total = probs.sum()
    probs = torch.where(total > 0, probs / torch.clamp_min(total, 1e-12),
                        torch.ones_like(probs))
    src = torch.multinomial(probs, capacity, replacement=True, generator=generator)

    # two-sample binomial opacity correction, 1 - sqrt(1 - o) for both copies
    new_op = 1.0 - torch.sqrt(torch.clamp(1.0 - op[src], 1e-6, 1.0))
    new_logit = torch.log(new_op / (1.0 - new_op))

    new_params = dict(params)
    for name in ("means", "scales", "quats", "sh0", "shN"):
        v = params[name]
        new_params[name] = torch.where(target.reshape((-1,) + (1,) * (v.ndim - 1)), v[src], v)
    new_params["opacities"] = torch.where(target, new_logit, params["opacities"])
    copied_from = torch.zeros(capacity + 1, dtype=torch.bool, device=op.device)
    copied_from[torch.where(target, src, torch.full_like(src, capacity))] = True
    copied_from = copied_from[:capacity]
    keep = torch.sqrt(torch.clamp(1.0 - op, 1e-6, 1.0))
    new_params["opacities"] = torch.where(
        copied_from,
        torch.log(torch.clamp(1.0 - keep, 1e-6, 1.0 - 1e-6) / torch.clamp_min(keep, 1e-6)),
        new_params["opacities"],
    )
    new_params["alive"] = alive | target
    return new_params, reset_slots(adam_state, target | copied_from)
