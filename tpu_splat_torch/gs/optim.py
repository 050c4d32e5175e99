"""Adam with slot-level control for densification (the port of
tpu_splat/gs/optim.py): moments are plain tensors that the strategy re-zeroes
when gaussians move between capacity slots, and `visible` restricts the update
to gaussians seen in the current view (selective Adam)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    mu: Params
    nu: Params
    count: torch.Tensor  # () int32


# The shN FIRST moment is stored in bf16 (shN is 45 of the 60 per-gaussian
# state channels; b1 = 0.9 increments survive bf16 rounding). The second
# moment stays f32: its 1e-3 increments fall below bf16 resolution near
# steady state. The arithmetic is f32 either way.
_BF16_MU = ("shN",)


def adam_init(params: Params, skip: tuple = ("alive",)) -> AdamState:
    def zeros(v, bf16: bool):
        return torch.zeros(v.shape, dtype=torch.bfloat16 if bf16 else v.dtype, device=v.device)

    mu = {k: zeros(v, k in _BF16_MU) for k, v in params.items() if k not in skip}
    nu = {k: zeros(v, False) for k, v in params.items() if k not in skip}
    device = next(iter(params.values())).device
    return AdamState(mu=mu, nu=nu, count=torch.zeros((), dtype=torch.int32, device=device))


def _rows(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def adam_update(
    params: Params,
    grads: Params,
    state: AdamState,
    lrs: Dict[str, object],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    visible: Optional[torch.Tensor] = None,
) -> tuple[Params, AdamState]:
    """One Adam step; lrs maps param name -> scalar lr (float or 0-d tensor).
    With `visible` (N,) bool only those rows get moment and parameter updates."""
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)

    new_params = dict(params)
    new_mu, new_nu = {}, {}
    for name in state.mu:
        g = grads[name]
        mu_old = state.mu[name].to(g.dtype)
        nu_old = state.nu[name].to(g.dtype)
        mu = b1 * mu_old + (1 - b1) * g
        nu = b2 * nu_old + (1 - b2) * (g * g)
        step = lrs[name] * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        if visible is not None:
            vis = _rows(visible, g.ndim)
            mu = torch.where(vis, mu, mu_old)
            nu = torch.where(vis, nu, nu_old)
            step = torch.where(vis, step, torch.zeros_like(step))
        new_mu[name] = mu.to(state.mu[name].dtype)
        new_nu[name] = nu.to(state.nu[name].dtype)
        new_params[name] = params[name] - step
    return new_params, AdamState(mu=new_mu, nu=new_nu, count=count)


def reset_slots(state: AdamState, mask: torch.Tensor) -> AdamState:
    """Zero first/second moments for slots where mask is True (new gaussians)."""

    def z(tree):
        return {k: torch.where(_rows(mask, v.ndim), torch.zeros_like(v), v)
                for k, v in tree.items()}

    return AdamState(mu=z(state.mu), nu=z(state.nu), count=state.count)
