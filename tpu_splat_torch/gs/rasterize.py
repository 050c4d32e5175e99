"""Differentiable tile rasterizer (the port of tpu_splat/gs/rasterize.py).

Binning keeps the reference's static-shape design so that the two packages
bin, pack and composite the same pairs:

1. every gaussian emits candidate (tile, gaussian) keys in tiers (first and
   second live cell of its 2x2 grid, corner-crossers, 4x4 and 8x8 coverage
   grids for large gaussians), culled exactly against each tile's rectangle;
2. keys `tile << shift | depth_rank` (int64 here; the reference sorts uint32)
   are sorted stably, so each tile's run is in depth order;
3. each tile keeps its first K pairs, which `_PackGather` gathers into the
   channel-major (16, T, K) block the compositing kernels read.

The gather's backward is its transpose, summed in a fixed order through an
inverse map from each key to its slot (`Binning.pair_slot`), so that it
repeats bit for bit on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from tpu_splat_torch.core.device import as_tensor, resolve_device
from tpu_splat_torch.core.errors import PipelineError
from tpu_splat_torch.gs import cuda_raster as cr

# A gaussian emits pairs to at most MAX_COVER_X x MAX_COVER_Y tiles.
MAX_COVER_X = 8
MAX_COVER_Y = 8
ALPHA_THRESHOLD = cr.ALPHA_THRESHOLD
MAX_ALPHA = cr.MAX_ALPHA


class RasterOutput(NamedTuple):
    color: torch.Tensor  # (H, W, 3)
    alpha: torch.Tensor  # (H, W) accumulated opacity
    depth: torch.Tensor  # (H, W) alpha-weighted depth


class Binning(NamedTuple):
    """tile_gaussians output."""

    gidx: torch.Tensor        # (T, K) int64 extended gaussian ids
    gvalid: torch.Tensor      # (T, K) bool
    mid_order: torch.Tensor   # (K_mid,) original ids of tier 1b
    big4_order: torch.Tensor  # (K_big4,) original ids of tier 2a
    big8_order: torch.Tensor  # (K_big8,) original ids of tier 2b
    mid_overflow: torch.Tensor  # () diagnostic
    big_overflow: torch.Tensor  # () diagnostic (tier-2a + 2b overflow)
    pair_slot: torch.Tensor   # (pairs,) each key's flat slot t * K + j, T * K if not kept


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _compact(mask: torch.Tensor, k: int):
    """Slots 0..k-1 for the first k set entries of `mask` (cumsum + scatter
    into a k+1 buffer whose last row takes the overflow, then a slice).
    Returns (order (k,), is_slot (k,), unselected mask, count)."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    count = pos[-1] + 1
    slot = torch.where(mask & (pos < k), pos, torch.full_like(pos, k))
    order = torch.zeros(k + 1, dtype=torch.int64, device=mask.device)
    order[slot] = torch.arange(n, device=mask.device)
    is_slot = torch.arange(k, device=mask.device) < count
    return order[:k], is_slot, mask & (pos >= k), count


@torch.no_grad()
def tile_gaussians(
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    width: int,
    height: int,
    tile_size: int,
    max_per_tile: int,
    opacities: Optional[torch.Tensor] = None,
) -> Binning:
    """Bin gaussians into per-tile depth-ordered index lists.

    gidx holds EXTENDED ids: tier-1b/2 pairs address rows appended after the
    N originals (feat[big4_order], feat[big8_order], feat[mid_order]), so no
    gaussian-id payload rides the sort. Tiers (see the reference docstring):
      0 : first live cell of the 2x2 grid (smalls), centre tile (overflowed bigs);
      1a: second live cell, original id;
      1b: corner-crossers (3-4 live cells), 2 extra keys each, K_mid slots;
      2a: bigs spanning <= 4x4 tiles, 4x4 grid, K_big4 slots;
      2b: the remaining bigs, 8x8 grid, K_big8 slots.
    """
    dev = means2d.device
    means2d, depths, radii = means2d.detach(), depths.detach(), radii.detach()
    n = means2d.shape[0]
    tx = _ceil_div(width, tile_size)
    ty = _ceil_div(height, tile_size)
    t_total = tx * ty
    if t_total >= (1 << 16):
        raise PipelineError(
            765,
            f"render {width}x{height} has {t_total} tiles (max 65535); "
            f"increase the training downscale factor",
        )
    tile_bits = max(1, t_total.bit_length())
    shift = 32 - tile_bits

    valid = radii > 0
    # IEEE bits of a positive float are order-preserving: their top bits are
    # the depth rank (ties keep pair order through the stable sort)
    depth_bits = torch.clamp_min(depths.float(), 1e-20).view(torch.int32).to(torch.int64)
    rank_u = depth_bits >> tile_bits

    mx, my = means2d[:, 0], means2d[:, 1]
    x0 = torch.clamp(torch.floor((mx - radii) / tile_size), 0, tx - 1).to(torch.int64)
    x1 = torch.clamp(torch.floor((mx + radii) / tile_size), 0, tx - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor((my - radii) / tile_size), 0, ty - 1).to(torch.int64)
    y1 = torch.clamp(torch.floor((my + radii) / tile_size), 0, ty - 1).to(torch.int64)
    big = valid & ((x1 - x0 > 1) | (y1 - y0 > 1))
    small = valid & ~big

    sentinel = t_total << shift

    def tile_miss(gx, gy, r, ptx, pty):
        """Exact circle-vs-tile cull: a pair whose mean-to-rectangle distance
        exceeds the alpha >= 1/255 radius is inert. The rectangle is padded
        0.5 px so every pixel centre stays inside."""
        lo_x = ptx.to(torch.float32) * tile_size - 0.5
        lo_y = pty.to(torch.float32) * tile_size - 0.5
        ddx = torch.clamp_min(torch.maximum(lo_x - gx, gx - (lo_x + tile_size)), 0.0)
        ddy = torch.clamp_min(torch.maximum(lo_y - gy, gy - (lo_y + tile_size)), 0.0)
        return ddx * ddx + ddy * ddy > r * r

    # the cull radius bounds the TRUE alpha >= 1/255 contour: projected radii
    # stop at 3 sigma, opaque gaussians reach further
    if opacities is not None:
        op = opacities.detach()
        k_exact = torch.sqrt(torch.clamp_min(
            2.0 * torch.log(torch.clamp_min(op * 255.0, 1e-6)), 0.0))
        radii_cull = radii * torch.clamp_min(k_exact / 3.0, 1.0)
    else:
        radii_cull = radii * (math.sqrt(2.0 * math.log(255.0)) / 3.0)

    cells = torch.arange(4, device=dev)
    px1 = x0[:, None] + cells % 2
    py1 = y0[:, None] + cells // 2
    live1 = small[:, None] & (px1 <= x1[:, None]) & (py1 <= y1[:, None])
    live1 &= ~tile_miss(mx[:, None], my[:, None], radii_cull[:, None], px1, py1)

    # ranks[:, c]: live cells among the first c+1 (a cumsum over 4 columns,
    # written out: a scan along a length-4 innermost dim is slow on the GPU)
    live_i = live1.to(torch.int64)
    ranks = torch.stack([live_i[:, 0], live_i[:, 0] + live_i[:, 1],
                         live_i[:, 0] + live_i[:, 1] + live_i[:, 2],
                         live_i.sum(dim=1)], dim=1)
    n_live = ranks[:, 3]

    def rth_cell(r):
        # first index of the r-th live cell (0 when there is none)
        return torch.argmax((live1 & (ranks == r)).to(torch.int32), dim=-1)

    def cell_tile(c):
        return (y0 + c // 2) * tx + (x0 + c % 2)

    big4 = big & (x1 - x0 <= 3) & (y1 - y0 <= 3)
    big8 = big & ~((x1 - x0 <= 3) & (y1 - y0 <= 3))
    k_big4 = min(max(n // 64, 4096), n)
    k_big8 = min(max(n // 256, 2048), n)
    big4_order, is_big4_slot, unsel4, count4 = _compact(big4, k_big4)
    big8_order, is_big8_slot, unsel8, count8 = _compact(big8, k_big8)
    big_unsel = unsel4 | unsel8
    big_overflow = (torch.clamp_min(count4 - k_big4, 0)
                    + torch.clamp_min(count8 - k_big8, 0))

    # tier 0
    tile0 = cell_tile(rth_cell(1))
    ok0 = n_live >= 1
    cxt = torch.clamp(torch.div(mx, tile_size, rounding_mode="floor").to(torch.int64), 0, tx - 1)
    cyt = torch.clamp(torch.div(my, tile_size, rounding_mode="floor").to(torch.int64), 0, ty - 1)
    tile0 = torch.where(big_unsel, cyt * tx + cxt, tile0)
    keys0 = torch.where(ok0 | big_unsel, (tile0 << shift) | rank_u, sentinel | rank_u)

    # tier 1a
    keys1a = torch.where(n_live >= 2, (cell_tile(rth_cell(2)) << shift) | rank_u,
                         sentinel | rank_u)

    # tier 1b
    k_mid = min(max(n // 16, 8192), n)
    mid_order, is_mid, _, mid_count = _compact(n_live >= 3, k_mid)
    mid_overflow = torch.clamp_min(mid_count - k_mid, 0)
    c3 = rth_cell(3)[mid_order]
    c4 = rth_cell(4)[mid_order]
    rank_mid = rank_u[mid_order]
    t3 = (y0[mid_order] + c3 // 2) * tx + (x0[mid_order] + c3 % 2)
    t4 = (y0[mid_order] + c4 // 2) * tx + (x0[mid_order] + c4 % 2)
    keys1b = torch.stack([
        torch.where(is_mid, (t3 << shift) | rank_mid, sentinel | rank_mid),
        torch.where(is_mid & (n_live[mid_order] >= 4),
                    (t4 << shift) | rank_mid, sentinel | rank_mid),
    ], dim=1).reshape(-1)

    # tier 2: coverage-grid keys for the compacted large gaussians
    def grid_keys(order, is_slot, gw, gh):
        m = torch.arange(gw * gh, device=dev)
        pxg = x0[order][:, None] + m % gw
        pyg = y0[order][:, None] + m // gw
        ok = is_slot[:, None] & (pxg <= x1[order][:, None]) & (pyg <= y1[order][:, None])
        ok &= ~tile_miss(mx[order][:, None], my[order][:, None],
                         radii_cull[order][:, None], pxg, pyg)
        rk = rank_u[order][:, None]
        return torch.where(ok, ((pyg * tx + pxg) << shift) | rk, sentinel | rk).reshape(-1)

    m2a = 16
    m2 = MAX_COVER_X * MAX_COVER_Y
    keys2a = grid_keys(big4_order, is_big4_slot, 4, 4)
    keys2b = grid_keys(big8_order, is_big8_slot, MAX_COVER_X, MAX_COVER_Y)

    keys = torch.cat([keys0, keys1a, keys1b, keys2a, keys2b])
    sorted_keys, sorted_pid = torch.sort(keys, stable=True)
    sorted_tile = sorted_keys >> shift
    # kernel-side gaussian id is arithmetic on the sorted pair id
    n1a = 2 * n
    n1b = n1a + 2 * k_mid
    n2a = n1b + m2a * k_big4
    sorted_gid = torch.where(
        sorted_pid < n, sorted_pid,
        torch.where(
            sorted_pid < n1a, sorted_pid - n,
            torch.where(
                sorted_pid < n1b, n + k_big4 + k_big8 + (sorted_pid - n1a) // 2,
                torch.where(
                    sorted_pid < n2a, n + (sorted_pid - n1b) // m2a,
                    n + k_big4 + (sorted_pid - n2a) // m2,
                ),
            ),
        ),
    )

    starts = torch.searchsorted(
        sorted_tile, torch.arange(t_total + 1, device=dev), right=False)
    tile_start, tile_end = starts[:-1], starts[1:]
    pos = tile_start[:, None] + torch.arange(max_per_tile, device=dev)
    gvalid = pos < tile_end[:, None]
    sorted_gid_pad = torch.cat(
        [sorted_gid, torch.zeros(max_per_tile, dtype=torch.int64, device=dev)])
    gidx = sorted_gid_pad[pos]
    # the inverse of the gather, for its backward: where each key (in key
    # order) landed in the (T, K) block, or T * K when it was not kept
    sorted_pos = torch.arange(sorted_tile.shape[0], device=dev)
    slot = sorted_pos - tile_start[sorted_tile.clamp_max(t_total - 1)]
    kept = (sorted_tile < t_total) & (slot < max_per_tile)
    pair_slot = torch.empty_like(sorted_pid)
    pair_slot[sorted_pid] = torch.where(kept, sorted_tile * max_per_tile + slot,
                                        t_total * max_per_tile)
    return Binning(gidx, gvalid, mid_order, big4_order, big8_order,
                   mid_overflow, big_overflow, pair_slot)


class _PackGather(torch.autograd.Function):
    """Gather feature rows into the channel-major (16, T, K) tile block.

    The source table is [feat; feat[big4_order]; feat[big8_order];
    feat[mid_order]; zero sentinel row], re-encoded in bf16 (means2d as a
    hi+lo pair) exactly as the reference packs it. The backward is the
    transpose of the gather, in a fixed order so that it repeats bit for bit
    on the card (an index_add_ over the slots sums duplicates with atomics
    there): each key's bf16-rounded slot gradient is read through the
    binning's inverse map (`pair_slot`), each table row sums its keys, whose
    count per row is fixed by its tier, and the tier rows fold back onto
    their gaussians (f32 throughout). The rounding is treated as identity."""

    @staticmethod
    def forward(ctx, feat, gidx_ext, mid_order, big4_order, big8_order, pair_slot):
        f16 = feat.to(torch.bfloat16)
        lo = (feat[:, 0:2] - f16[:, 0:2].to(torch.float32)).to(torch.bfloat16)
        # 0:2 mean hi | 2:4 mean lo | 4:7 conic | 7:10 rgb | 10 op | 11 depth | pad
        enc = torch.cat([f16[:, 0:2], lo, f16[:, 2:10], torch.zeros_like(f16[:, :4])], 1)
        enc_ext = torch.cat([enc, enc[big4_order], enc[big8_order], enc[mid_order],
                             torch.zeros_like(enc[:1])], 0)
        t, k = gidx_ext.shape
        g = enc_ext[gidx_ext.reshape(-1)].T.reshape(cr.C_PACK, t, k).to(torch.float32)
        ctx.save_for_backward(gidx_ext, mid_order, big4_order, big8_order, pair_slot)
        ctx.n = feat.shape[0]
        return torch.cat([g[0:2] + g[2:4], g[4:12], torch.zeros_like(g[0:6])], 0)

    @staticmethod
    def backward(ctx, d_packed):
        _, mid_order, big4_order, big8_order, pair_slot = ctx.saved_tensors
        n, c = ctx.n, d_packed.shape[0]
        km, k4, k8 = mid_order.shape[0], big4_order.shape[0], big8_order.shape[0]
        rows = d_packed.to(torch.bfloat16).to(torch.float32).reshape(c, -1).T
        d = torch.cat([rows, torch.zeros_like(rows[:1])])[pair_slot]  # (keys, C)
        # the key order of tile_gaussians: tier 0 and tier 1a (one key each per
        # gaussian), then 2 keys per tier-1b slot, 16 per 4x4 and 64 per 8x8
        n1b, n2a = 2 * n + 2 * km, 2 * n + 2 * km + 16 * k4
        d_feat = d[:n] + d[n:2 * n]
        # the orders repeat an id only in unused slots, whose keys were all
        # dropped: their sums are exact zeros, so each fold is order-free
        d_feat.index_add_(0, big4_order, d[n1b:n2a].reshape(k4, 16, c).sum(1))
        d_feat.index_add_(0, big8_order, d[n2a:].reshape(k8, 64, c).sum(1))
        d_feat.index_add_(0, mid_order, d[2 * n:n1b].reshape(km, 2, c).sum(1))
        return d_feat, None, None, None, None, None


def pack_tiles(means2d, conics, colors, opacities, depths, radii, width: int,
               height: int, tile_size: int = 16, max_per_tile: int = 512):
    """Bin and pack: returns (packed (16, T, K), counts (T,) int32, Binning).
    counts is each tile's real pair count, which bounds the kernel's sweep."""
    b = tile_gaussians(means2d, depths, radii, width, height, tile_size,
                       max_per_tile, opacities=opacities)
    n = means2d.shape[0]
    feat = torch.cat(
        [means2d, conics, colors, opacities[:, None], depths[:, None],
         torch.zeros((n, cr.C_PACK - 10), dtype=means2d.dtype, device=means2d.device)],
        dim=-1,
    )
    sentinel_row = n + b.big4_order.shape[0] + b.big8_order.shape[0] + b.mid_order.shape[0]
    gidx_ext = torch.where(b.gvalid, b.gidx, torch.full_like(b.gidx, sentinel_row))
    packed = _PackGather.apply(feat, gidx_ext, b.mid_order, b.big4_order, b.big8_order,
                               b.pair_slot)
    counts = b.gvalid.sum(dim=1, dtype=torch.int32)
    return packed, counts, b


def rasterize(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    width: int,
    height: int,
    background: Optional[torch.Tensor] = None,
    tile_size: int = 16,
    max_per_tile: int = 512,
    device=None,
) -> RasterOutput:
    """Alpha-composite projected gaussians into an image.

    means2d (N,2), conics (N,3), colors (N,3), opacities (N,) post-sigmoid,
    depths (N,), radii (N,) with 0 = culled. Compositing runs in the CUDA
    kernels (cuda_raster.py) on the GPU, in their plain versions on the CPU.
    """
    dev = resolve_device(device)
    if tile_size != cr.TILE:
        raise ValueError(f"the kernels assume {cr.TILE}x{cr.TILE} tiles")
    if max_per_tile % cr.CHUNK:
        raise ValueError(f"max_per_tile must be a multiple of {cr.CHUNK}")
    means2d, conics, colors, opacities, depths, radii = (
        as_tensor(x, dev) for x in (means2d, conics, colors, opacities, depths, radii))
    tx = _ceil_div(width, tile_size)
    ty = _ceil_div(height, tile_size)

    packed, counts, _ = pack_tiles(means2d, conics, colors, opacities, depths,
                                   radii, width, height, tile_size, max_per_tile)
    out8 = cr.composite_tiles(packed, counts, tx, ty)

    accum = out8[:, 0:3, :].transpose(1, 2)  # (T, P, 3)
    alpha_t = out8[:, 3, :]
    depth_t = out8[:, 4, :]
    if background is not None:
        accum = accum + (1.0 - alpha_t)[..., None] * as_tensor(background, dev)

    def untile(arr, c):
        img = arr.reshape(ty, tx, tile_size, tile_size, c)
        img = img.permute(0, 2, 1, 3, 4).reshape(ty * tile_size, tx * tile_size, c)
        return img[:height, :width]

    return RasterOutput(
        color=untile(accum, 3),
        alpha=untile(alpha_t[..., None], 1)[..., 0],
        depth=untile(depth_t[..., None], 1)[..., 0],
    )
