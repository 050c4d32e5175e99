"""Convert training state between the JAX package's numpy form and the port's
tensors: the parameter dict and the Adam state (mu, nu, count).

Arrays cross as numpy, so this module needs neither JAX nor the reference
package. bf16 arrays (the shN first moment) arrive as numpy arrays of the
`bfloat16` extension dtype and leave as float32 arrays holding the same
bf16-representable values; the caller casts them back.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.gs.optim import AdamState


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device).to(torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def params_to_torch(params: Mapping[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """JAX parameter dict (numpy arrays) -> the port's tensors on `device`."""
    dev = resolve_device(device)
    return {k: _to_tensor(v, dev) for k, v in params.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's parameter dict -> numpy arrays (bf16 widened to float32)."""
    return {k: _to_numpy(v) for k, v in params.items()}


def adam_to_torch(mu: Mapping[str, np.ndarray], nu: Mapping[str, np.ndarray], count,
                  device=None) -> AdamState:
    """JAX AdamState fields (numpy) -> the port's AdamState."""
    dev = resolve_device(device)
    return AdamState(
        mu=params_to_torch(mu, dev),
        nu=params_to_torch(nu, dev),
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=dev),
    )


def adam_to_numpy(state: AdamState) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                                             np.ndarray]:
    """The port's AdamState -> (mu, nu, count) as numpy."""
    return params_to_numpy(state.mu), params_to_numpy(state.nu), _to_numpy(state.count)
