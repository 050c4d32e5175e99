"""Tile compositing: the CUDA kernels, their plain PyTorch versions, and the
autograd.Function that joins them (the port of tpu_splat/gs/pallas_raster.py).

Both operate on the packed (16, T, K) tensor that rasterize._PackGather builds.
Channels: 0:2 mean2d | 2:5 conic (a, b, c) | 5:8 rgb | 8 opacity | 9 depth |
10:16 pad. The forward returns out (T, 8, 256) with rows 0:3 rgb, 3 alpha
(1 - T_final), 4 depth, 5:8 zero, and tstart (T, K/128 * 256): each chunk's
start transmittance, 0 for chunks the sweep never reached.

Semantics kept from the reference kernels: 16x16 tiles, 128-gaussian chunks,
alpha = min(op * exp(-max(sigma, 0)), 0.999) zeroed where sigma < 0 or the raw
alpha is below 1/255, and a TILE-wide exit checked once before each chunk
(max T <= 1e-4), with the sweep bounded by the tile's pair count.

On a CUDA tensor the wrappers launch the kernels in csrc/composite.cu, on that
tensor's card, or raise; the plain versions run only for tensors on the CPU.

With TPU_SPLAT_LAUNCH_DIR set when this module is imported, the process writes
its launch counts to <dir>/launches_<pid>.json as it exits, so a caller can
read the counts of the ranks and job processes it started.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import json
import os
from typing import Tuple

import torch

from tpu_splat_torch import kernel_build

C_PACK = 16
CHUNK = 128
TILE = 16
P = TILE * TILE
TERM_THRESHOLD = 1e-4
ALPHA_THRESHOLD = 1.0 / 255.0
MAX_ALPHA = 0.999

# Kernel launches per wrapper; each wrapper adds one where it launches
# (optim.adam_update_cuda adds to "adam").
LAUNCHES = {"composite_fwd": 0, "composite_bwd": 0, "adam": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


LAUNCH_DIR_ENV = "TPU_SPLAT_LAUNCH_DIR"


def _write_launches(directory: str) -> None:
    with open(os.path.join(directory, f"launches_{os.getpid()}.json"), "w") as f:
        json.dump(LAUNCHES, f)


if os.environ.get(LAUNCH_DIR_ENV):
    atexit.register(_write_launches, os.environ[LAUNCH_DIR_ENV])


# ---------------------------------------------------------------- plain versions

def _pixel_coords(t_total: int, tx: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, P) pixel-centre x and y of every tile."""
    tile = torch.arange(t_total, device=device)[:, None]
    lin = torch.arange(P, device=device)[None, :]
    px = ((tile % tx) * TILE + lin % TILE).to(torch.float32) + 0.5
    py = ((tile // tx) * TILE + lin // TILE).to(torch.float32) + 0.5
    return px, py


def _chunk_alpha(blk, px, py):
    """blk (T, CHUNK, 16) -> (alpha, live, alpha_raw, dx, dy), each (T, CHUNK, P).
    composite.cu's chunk_alpha rounds every operation in this order."""
    dx = px[:, None, :] - blk[..., 0:1]
    dy = py[:, None, :] - blk[..., 1:2]
    sigma = 0.5 * (blk[..., 2:3] * dx * dx + blk[..., 4:5] * dy * dy) + blk[..., 3:4] * dx * dy
    alpha_raw = blk[..., 8:9] * torch.exp(-torch.clamp_min(sigma, 0.0))
    live = (sigma >= 0.0) & (alpha_raw >= ALPHA_THRESHOLD)
    alpha = torch.where(live, torch.clamp_max(alpha_raw, MAX_ALPHA), torch.zeros_like(alpha_raw))
    return alpha, live, alpha_raw, dx, dy


def _exclusive_prefix(one_minus):
    """Transmittance within a chunk before each gaussian, and the chunk product."""
    cum = torch.cumprod(one_minus, dim=1)
    return torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1), cum[:, -1]


def composite_tiles_plain(packed: torch.Tensor, counts: torch.Tensor, tx: int,
                          ty: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward: packed (16, T, K), counts (T,) -> (out, tstart).
    Differentiable by torch autograd (the tests use that as a second oracle)."""
    _, t_total, k = packed.shape
    n_chunks = k // CHUNK
    blocks = packed.permute(1, 2, 0)  # (T, K, 16)
    px, py = _pixel_coords(t_total, tx, packed.device)
    n_lim = torch.clamp_max((counts.to(torch.int64) + CHUNK - 1) // CHUNK, n_chunks)
    accum = packed.new_zeros((t_total, 3, P))
    depth = packed.new_zeros((t_total, P))
    trans = packed.new_ones((t_total, P))
    tstart = []
    for c in range(n_chunks):
        # trans never grows, so once a tile is off it stays off
        on = (c < n_lim) & (trans.amax(dim=1) > TERM_THRESHOLD)
        tstart.append(torch.where(on[:, None], trans, torch.zeros_like(trans)).detach())
        blk = blocks[:, c * CHUNK:(c + 1) * CHUNK]
        alpha = _chunk_alpha(blk, px, py)[0]
        t_within, chunk_prod = _exclusive_prefix(1.0 - alpha)
        w = alpha * t_within * trans[:, None, :] * on[:, None, None]
        accum = accum + torch.einsum("tkp,tkc->tcp", w, blk[..., 5:8])
        depth = depth + torch.sum(w * blk[..., 9:10], dim=1)
        trans = torch.where(on[:, None], trans * chunk_prod, trans)
    out = torch.cat([accum, (1.0 - trans)[:, None], depth[:, None],
                     packed.new_zeros((t_total, 3, P))], dim=1)
    return out, torch.stack(tstart, dim=1).reshape(t_total, n_chunks * P)


def composite_tiles_bwd_plain(packed: torch.Tensor, gout: torch.Tensor,
                              tstart: torch.Tensor, t_final: torch.Tensor,
                              tx: int) -> torch.Tensor:
    """Plain analytic backward: (packed, gout (T, 8, P), tstart, t_final (T, P))
    -> dpacked (16, T, K). A reverse chunk sweep from the tstart checkpoints
    that skips chunks never reached, with the per-pixel suffix
    S = sum_{j>i} w_j e_j, e = rgb . dC + depth * dD, and
    d alpha = T_i e - S/(1-alpha) + dA T_final/(1-alpha) (1-alpha floored at 1e-3)."""
    _, t_total, k = packed.shape
    n_chunks = k // CHUNK
    blocks = packed.permute(1, 2, 0)
    px, py = _pixel_coords(t_total, tx, packed.device)
    dC = gout[:, 0:3, :]
    dA = gout[:, 3, :][:, None, :]
    dD = gout[:, 4, :][:, None, :]
    tf = t_final[:, None, :]
    ts = tstart.reshape(t_total, n_chunks, P)
    suffix = packed.new_zeros((t_total, P))
    grads = [None] * n_chunks
    for c in reversed(range(n_chunks)):
        t_start = ts[:, c]
        chunk_live = t_start.amax(dim=1) > 0.0  # (T,)
        blk = blocks[:, c * CHUNK:(c + 1) * CHUNK]
        alpha, live, alpha_raw, dx, dy = _chunk_alpha(blk, px, py)
        one_minus = 1.0 - alpha
        t_within, _ = _exclusive_prefix(one_minus)
        t_i = t_within * t_start[:, None, :]
        w = alpha * t_i
        rgb = blk[..., 5:8]
        e = (rgb[..., 0:1] * dC[:, None, 0] + rgb[..., 1:2] * dC[:, None, 1]
             + rgb[..., 2:3] * dC[:, None, 2] + blk[..., 9:10] * dD)
        we = w * e
        # strict suffix within the chunk, as an exclusive reverse cumsum
        rev = torch.flip(we, dims=[1])
        excl = torch.cat([torch.zeros_like(rev[:, :1]), torch.cumsum(rev, dim=1)[:, :-1]], dim=1)
        s_after = torch.flip(excl, dims=[1]) + suffix[:, None, :]
        inv_om = 1.0 / torch.clamp_min(one_minus, 1e-3)
        dalpha = t_i * e - s_after * inv_om + dA * tf * inv_om
        active = live & (alpha_raw < MAX_ALPHA)
        dalpha = torch.where(active, dalpha, torch.zeros_like(dalpha))
        dsigma = -alpha * dalpha
        op = blk[..., 8:9]
        exp_neg_sigma = alpha_raw / torch.clamp_min(op, 1e-12)
        dop = torch.sum(exp_neg_sigma * dalpha, dim=2)
        ca, cb, cc = blk[..., 2:3], blk[..., 3:4], blk[..., 4:5]
        gx = ca * dx + cb * dy
        gy = cc * dy + cb * dx
        g = torch.stack([
            -torch.sum(gx * dsigma, dim=2),
            -torch.sum(gy * dsigma, dim=2),
            torch.sum(0.5 * dx * dx * dsigma, dim=2),
            torch.sum(dx * dy * dsigma, dim=2),
            torch.sum(0.5 * dy * dy * dsigma, dim=2),
            *torch.einsum("tkp,tcp->ctk", w, dC),
            dop,
            torch.sum(w * dD, dim=2),
        ])  # (10, T, CHUNK)
        g = torch.where(chunk_live[None, :, None], g, torch.zeros_like(g))
        grads[c] = torch.cat([g, g.new_zeros((C_PACK - 10, t_total, CHUNK))])
        suffix = torch.where(chunk_live[:, None], suffix + we.sum(dim=1), suffix)
    return torch.cat(grads, dim=2)


# ---------------------------------------------------------------- CUDA wrappers

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The compositing library, built at first use (kernel_build.py)."""
    lib = kernel_build.load("composite")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tsp_composite_fwd.argtypes = [vp, vp, vp, vp, i, i, i, vp]
    lib.tsp_composite_fwd.restype = i
    lib.tsp_composite_bwd.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, vp]
    lib.tsp_composite_bwd.restype = i
    return lib


def _check(name: str, x: torch.Tensor, dtype, shape, device=None) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and x.device != device:
        raise ValueError(f"{name} must be on {device}, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError {err}")


def composite_fwd_cuda(packed: torch.Tensor, counts: torch.Tensor,
                       tx: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: (16, T, K) f32, (T,) int32 -> (out, tstart)."""
    c, t_total, k = packed.shape
    if c != C_PACK or k % CHUNK:
        raise ValueError(f"packed must be (16, T, K) with K a multiple of {CHUNK}")
    _check("packed", packed, torch.float32, (C_PACK, t_total, k))
    _check("counts", counts, torch.int32, (t_total,), packed.device)
    out = torch.empty((t_total, 8, P), dtype=torch.float32, device=packed.device)
    tstart = torch.empty((t_total, (k // CHUNK) * P), dtype=torch.float32,
                         device=packed.device)
    # the library launches on the thread's current card: make it the tensor's
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = _lib().tsp_composite_fwd(packed.data_ptr(), counts.data_ptr(), out.data_ptr(),
                                       tstart.data_ptr(), t_total, k, tx, stream)
    _launch_check(err, "composite_fwd")
    LAUNCHES["composite_fwd"] += 1
    return out, tstart


def composite_bwd_cuda(packed: torch.Tensor, counts: torch.Tensor, gout: torch.Tensor,
                       tstart: torch.Tensor, t_final: torch.Tensor, tx: int) -> torch.Tensor:
    """Launch the backward kernel -> dpacked (16, T, K). counts (T,) int32 cuts
    each tile's sweep at its pair count; the slots past it must be the zero
    sentinel row, and come back as zeros."""
    c, t_total, k = packed.shape
    if c != C_PACK or k % CHUNK:
        raise ValueError(f"packed must be (16, T, K) with K a multiple of {CHUNK}")
    _check("packed", packed, torch.float32, (C_PACK, t_total, k))
    _check("counts", counts, torch.int32, (t_total,), packed.device)
    _check("gout", gout, torch.float32, (t_total, 8, P), packed.device)
    _check("tstart", tstart, torch.float32, (t_total, (k // CHUNK) * P), packed.device)
    _check("t_final", t_final, torch.float32, (t_total, P), packed.device)
    dpacked = torch.empty_like(packed)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = _lib().tsp_composite_bwd(packed.data_ptr(), counts.data_ptr(), gout.data_ptr(),
                                       tstart.data_ptr(), t_final.data_ptr(),
                                       dpacked.data_ptr(), t_total, k, tx, stream)
    _launch_check(err, "composite_bwd")
    LAUNCHES["composite_bwd"] += 1
    return dpacked


class _CompositeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, counts, tx, ty):
        if packed.is_cuda:
            out, tstart = composite_fwd_cuda(packed, counts, tx)
        else:
            out, tstart = composite_tiles_plain(packed, counts, tx, ty)
        # T_final is saved directly; the backward needs it for the dA term
        ctx.save_for_backward(packed, counts, tstart, 1.0 - out[:, 3, :])
        ctx.tx = tx
        return out

    @staticmethod
    def backward(ctx, gout):
        packed, counts, tstart, t_final = ctx.saved_tensors
        gout = gout.contiguous()
        if packed.is_cuda:
            dpacked = composite_bwd_cuda(packed, counts, gout, tstart, t_final.contiguous(),
                                         ctx.tx)
        else:
            dpacked = composite_tiles_bwd_plain(packed, gout, tstart, t_final, ctx.tx)
        return dpacked, None, None, None


def composite_tiles(packed: torch.Tensor, counts: torch.Tensor, tx: int,
                    ty: int) -> torch.Tensor:
    """packed (16, T, K) -> out (T, 8, 256), differentiable in packed.
    counts (T,) int32: each tile's real pair count; slots past it must be the
    zero sentinel row."""
    return _CompositeTiles.apply(packed.contiguous(), counts.to(torch.int32).contiguous(),
                                 tx, ty)
