"""Adam with slot-level control for densification (the port of
tpu_splat/gs/optim.py): moments are plain tensors that the strategy re-zeroes
when gaussians move between capacity slots, `visible` restricts the update
to gaussians seen in the current view (selective Adam), and `grad_mask`
zeroes the gradients of dead slots.

On a CUDA state the whole update is one launch of the kernel in
csrc/adam.cu (counted in cuda_raster.LAUNCHES["adam"]); its plain PyTorch
version runs for a state on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from tpu_splat_torch import kernel_build
from tpu_splat_torch.gs import cuda_raster as cr

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
# what one launch of csrc/adam.cu takes: its table's leaves, and int32 indices
_MAX_LEAVES = 8
_MAX_ELEMENTS = 2**31 - 9


def adam_init(params: Params, skip: tuple = ("alive",)) -> AdamState:
    def zeros(v, bf16: bool):
        return torch.zeros(v.shape, dtype=torch.bfloat16 if bf16 else v.dtype, device=v.device)

    mu = {k: zeros(v, k in _BF16_MU) for k, v in params.items() if k not in skip}
    nu = {k: zeros(v, False) for k, v in params.items() if k not in skip}
    device = next(iter(params.values())).device
    return AdamState(mu=mu, nu=nu, count=torch.zeros((), dtype=torch.int32, device=device))


def _rows(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def _bias_corrections(state: AdamState, b1: float, b2: float):
    """(count + 1, 1 - b1^count, 1 - b2^count), on the state's device."""
    count = state.count + 1
    c = count.to(torch.float32)
    return count, 1.0 - torch.pow(b1, c), 1.0 - torch.pow(b2, c)


def adam_update_plain(
    params: Params,
    grads: Params,
    state: AdamState,
    lrs: Dict[str, object],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    visible: Optional[torch.Tensor] = None,
    grad_mask: Optional[torch.Tensor] = None,
) -> tuple[Params, AdamState]:
    """adam_update in plain PyTorch, on any device: the CPU's path, and what
    the kernel is held against on the card."""
    count, bc1, bc2 = _bias_corrections(state, b1, b2)
    new_params = dict(params)
    new_mu, new_nu = {}, {}
    for name in state.mu:
        g = grads[name]
        if grad_mask is not None:
            g = torch.where(_rows(grad_mask, g.ndim), g, torch.zeros_like(g))
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


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The Adam library, built at first use (kernel_build.py)."""
    lib = kernel_build.load("adam")
    vp, f = ctypes.c_void_p, ctypes.c_float
    lib.tsp_adam.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_longlong),
                             ctypes.POINTER(f), ctypes.c_int, vp, vp, vp, vp, f, f, f, f, f, vp]
    lib.tsp_adam.restype = ctypes.c_int
    return lib


# The layout of the last launch of the kernel: its rows, each leaf's elements
# and first-moment bytes an element, and which row masks it read. A reader
# of the kernel's device time counts its least bytes from it.
LAST_LAUNCH: dict = {}


def adam_update_cuda(
    params: Params,
    grads: Params,
    state: AdamState,
    lrs: Dict[str, float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    visible: Optional[torch.Tensor] = None,
    grad_mask: Optional[torch.Tensor] = None,
) -> tuple[Params, AdamState]:
    """adam_update as one launch of csrc/adam.cu's kernel over every leaf of
    the state, with adam_update_plain's arithmetic, on the card of the step
    count. The inputs are left as they were; the results are new tensors.
    Leaves, gradients and moments share one shape a leaf and one row count,
    and are contiguous; the first moment is f32 or bf16, the rest f32; the
    learning rates are host floats."""
    dev = state.count.device
    count, bc1, bc2 = _bias_corrections(state, b1, b2)
    new_params = dict(params)
    new_mu, new_nu = dict(state.mu), dict(state.nu)
    rows = None
    ptrs, sizes, rates, layout = [], [], [], []
    for name in state.mu:
        p, g, mu, nu = params[name], grads[name], state.mu[name], state.nu[name]
        shape = tuple(p.shape)
        cr._check(name, p, torch.float32, shape, dev)
        if p.ndim == 0:
            raise ValueError(f"{name} must have a row axis")
        if rows is not None and shape[0] != rows:
            raise ValueError(f"{name} has {shape[0]} rows, the other leaves {rows}")
        rows = shape[0]
        cr._check(f"the gradient of {name}", g, torch.float32, shape, dev)
        if mu.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the first moment of {name} must be f32 or bf16, got {mu.dtype}")
        cr._check(f"the first moment of {name}", mu, mu.dtype, shape, dev)
        cr._check(f"the second moment of {name}", nu, torch.float32, shape, dev)
        lr = lrs[name]
        if isinstance(lr, torch.Tensor):
            raise ValueError(f"the learning rate of {name} must be a host float")
        if p.numel() == 0:  # a degree-0 cloud's shN
            continue
        if p.numel() > _MAX_ELEMENTS:
            raise ValueError(f"{name} has {p.numel()} elements; the kernel takes "
                             f"{_MAX_ELEMENTS} a leaf")
        outs = (torch.empty_like(p), torch.empty_like(mu), torch.empty_like(nu))
        new_params[name], new_mu[name], new_nu[name] = outs
        ptrs += [t.data_ptr() for t in (p, g, mu, nu, *outs)]
        sizes += [p.numel(), p.numel() // rows, int(mu.dtype == torch.bfloat16)]
        rates.append(float(lr))
        layout.append((p.numel(), mu.element_size()))
    if len(rates) > _MAX_LEAVES:
        raise ValueError(f"{len(rates)} leaves; the kernel takes {_MAX_LEAVES}")
    for what, mask in (("grad_mask", grad_mask), ("visible", visible)):
        if mask is not None:
            cr._check(what, mask, torch.bool, (rows,), dev)
    if rates:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib().tsp_adam(
                (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * len(sizes))(*sizes),
                (ctypes.c_float * len(rates))(*rates), len(rates),
                None if grad_mask is None else grad_mask.data_ptr(),
                None if visible is None else visible.data_ptr(),
                bc1.data_ptr(), bc2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, stream)
        cr._launch_check(err, "adam")
        cr.LAUNCHES["adam"] += 1
        LAST_LAUNCH.clear()
        LAST_LAUNCH.update(rows=rows, leaves=layout, grad_mask=grad_mask is not None,
                           visible=visible is not None)
    return new_params, AdamState(mu=new_mu, nu=new_nu, count=count)


def adam_update(
    params: Params,
    grads: Params,
    state: AdamState,
    lrs: Dict[str, object],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    visible: Optional[torch.Tensor] = None,
    grad_mask: Optional[torch.Tensor] = None,
) -> tuple[Params, AdamState]:
    """One Adam step; lrs maps param name -> scalar lr (a float; on the CPU
    also a 0-d tensor). With `visible` (N,) bool only those rows get moment
    and parameter updates; with `grad_mask` (N,) bool the other rows' gradients
    count as 0. On a CUDA state the kernel in csrc/adam.cu runs it
    (adam_update_cuda), on the CPU adam_update_plain."""
    update = adam_update_cuda if state.count.is_cuda else adam_update_plain
    return update(params, grads, state, lrs, b1, b2, eps, visible, grad_mask)


def reset_slots(state: AdamState, mask: torch.Tensor) -> AdamState:
    """Zero first/second moments for slots where mask is True (new gaussians)."""

    def z(tree):
        return {k: torch.where(_rows(mask, v.ndim), torch.zeros_like(v), v)
                for k, v in tree.items()}

    return AdamState(mu=z(state.mu), nu=z(state.nu), count=state.count)
