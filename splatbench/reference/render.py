"""Plain PyTorch render of one view of a splat: EWA projection, SH colour,
sort-based tile binning, the bf16 pack and alpha compositing.

This is the benchmark's own frozen statement of what the trained program
computes. It imports nothing of the program and uses no kernel: every step is
a plain torch operation in float32, differentiable by autograd. Compositing,
the only step whose intermediates do not fit at full size, runs in blocks of
tiles: the forward under no_grad, and the backward by recomputing each block's
forward under autograd (`_Composite`).

Semantics followed (the program's job configuration): 16x16 tiles, at most K
gaussians a tile in depth order, 128-gaussian chunks with a tile-wide exit
once max T <= 1e-4 before a chunk, alpha = min(op exp(-sigma), 0.999) cut
below 1/255, coverage tiers of at most 8x8 tiles a gaussian with overflow to
the centre tile, and packed values rounded to bf16 (means as a hi + lo pair),
their gradients rounded to bf16 on the way back.

`precision.tf32` makes every matrix product round its inputs to TF32 (10
mantissa bits), the lower precision the control computes in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TILE = 16
P = TILE * TILE
CHUNK = 128
C_PACK = 16
TERM_THRESHOLD = 1e-4
ALPHA_THRESHOLD = 1.0 / 255.0
MAX_ALPHA = 0.999
EPS2D = 0.3
MAX_COVER = 8
BLOCK_TILES = 512  # tiles composited together; bounds the block's memory

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Precision:
    """Whether matrix products round their inputs to TF32."""

    tf32 = False


precision = Precision()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to 10 mantissa bits (nearest, ties away), as TF32
    tensor-core inputs are rounded; the gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if precision.tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if precision.tf32:
        a, b = round_tf32(a), round_tf32(b)
    return torch.einsum(eq, a, b)


# ---------------------------------------------------------------- geometry

def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    q = quats / torch.clamp_min(torch.linalg.norm(quats, dim=-1, keepdim=True), 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues in its sinc form (finite gradient at w = 0)."""
    n2 = torch.sum(w * w)
    t2 = n2 + 1e-12
    theta = torch.sqrt(t2)
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / t2
    z = torch.zeros_like(w[0])
    k = torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                     torch.stack([-w[1], w[0], z])])
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * k + b * (k @ k)


def apply_camera_delta(viewmat: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Left-apply an se(3) delta (w, dt) to a 4x4 world-to-camera matrix."""
    R = exp_so3(delta[:3]) @ viewmat[:3, :3]
    t = viewmat[:3, 3] + delta[3:]
    return torch.cat([torch.cat([R, t[:, None]], dim=1), viewmat[3:4]], dim=0)


class Projected(NamedTuple):
    means2d: torch.Tensor
    conics: torch.Tensor
    depths: torch.Tensor
    radii: torch.Tensor
    compensations: torch.Tensor


def project(means, log_scales, quats, viewmat, fx, fy, cx, cy, width, height,
            antialiased=False, opacities=None, near=0.01, far=1e10) -> Projected:
    """EWA splatting: cov2d = J W Sigma W^T J^T + 0.3 I, with the tangent-plane
    clamp at 1.3x the half field of view, and radii from the opacity-aware
    extent sqrt(2 ln(255 op)) sigma capped at 3 sigma (3 sigma without op)."""
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    p = mm(means, R.T) + t
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    zs = torch.clamp_min(z, 1e-6)
    lim_x, lim_y = 1.3 * (0.5 * width / fx), 1.3 * (0.5 * height / fy)
    tx = torch.clamp(x / zs, -lim_x, lim_x) * zs
    ty = torch.clamp(y / zs, -lim_y, lim_y) * zs
    M = (R[None, :, :, None] * quat_to_rotmat(quats)[:, None, :, :]).sum(dim=2)
    M = M * torch.exp(log_scales)[:, None, :]
    C = (M[:, :, None, :] * M[:, None, :, :]).sum(dim=-1)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    f1, f2 = fx * inv_z, fy * inv_z
    j13, j23 = -fx * tx * inv_z2, -fy * ty * inv_z2
    a = f1 * f1 * C[:, 0, 0] + 2 * f1 * j13 * C[:, 0, 2] + j13 * j13 * C[:, 2, 2]
    c = f2 * f2 * C[:, 1, 1] + 2 * f2 * j23 * C[:, 1, 2] + j23 * j23 * C[:, 2, 2]
    b = (f1 * f2 * C[:, 0, 1] + f1 * j23 * C[:, 0, 2] + f2 * j13 * C[:, 1, 2]
         + j13 * j23 * C[:, 2, 2])
    det_raw = a * c - b * b
    a, c = a + EPS2D, c + EPS2D
    det = torch.clamp_min(a * c - b * b, 1e-12)
    comp = torch.sqrt(torch.clamp_min(det_raw, 0.0) / det)
    inv_det = 1.0 / det
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    means2d = torch.stack([fx * x * inv_z + cx, fy * y * inv_z + cy], dim=-1)
    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    if opacities is not None:
        k = torch.clamp_max(torch.sqrt(torch.clamp_min(
            2.0 * torch.log(torch.clamp_min(opacities * 255.0, 1e-6)), 0.0)), 3.0)
        visible_op = opacities * 255.0 > 1.0
    else:
        k = 3.0
        visible_op = torch.ones_like(z, dtype=torch.bool)
    radius = torch.ceil(k * torch.sqrt(torch.clamp_min(lambda1, 0.0)))
    inside = ((z > near) & (z < far) & visible_op & (radius > 0)
              & (means2d[:, 0] + radius > 0) & (means2d[:, 0] - radius < width)
              & (means2d[:, 1] + radius > 0) & (means2d[:, 1] - radius < height))
    radii = torch.where(inside, radius, torch.zeros_like(radius)).detach()
    if not antialiased:
        comp = torch.ones_like(comp)
    return Projected(means2d, conic, z, radii, comp)


def sh_color(sh0, shN, dirs, degree):
    """Real SH of degrees 0..3 in the 3DGS ordering, + 0.5, clipped at 0."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
                  SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3.0 * yy)]
    basis = torch.stack(basis, dim=-1)
    color = sh0 * basis[:, :1]
    nb = basis.shape[1] - 1
    if nb:
        color = color + (basis[:, 1:, None] * shN[:, :nb, :]).sum(dim=1)
    return torch.clamp_min(color + 0.5, 0.0)


# ---------------------------------------------------------------- binning

class Binning(NamedTuple):
    gidx: torch.Tensor        # (T, K) extended ids (see below)
    gvalid: torch.Tensor      # (T, K)
    mid_order: torch.Tensor
    big4_order: torch.Tensor
    big8_order: torch.Tensor


def _compact(mask: torch.Tensor, k: int):
    """Slots for the first k set entries of mask: (order, is_slot, rest, count)."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    count = pos[-1] + 1
    slot = torch.where(mask & (pos < k), pos, torch.full_like(pos, k))
    order = torch.zeros(k + 1, dtype=torch.int64, device=mask.device)
    order[slot] = torch.arange(n, device=mask.device)
    return order[:k], torch.arange(k, device=mask.device) < count, mask & (pos >= k), count


@torch.no_grad()
def bin_tiles(means2d, depths, radii, opacities, width, height, k_tile) -> Binning:
    """Every gaussian emits (tile, depth rank) keys in tiers, culled against
    each tile's rectangle by its alpha >= 1/255 radius; a stable sort puts
    each tile's keys in depth order and the tile keeps its first k_tile.

    Tiers: 0, the first live cell of a small gaussian's 2x2 grid (the centre
    tile for a large gaussian that overflowed its tier); 1a, the second live
    cell; 1b, the third and fourth (n/16 slots, at least 8192); 2a, the 4x4
    grid of large gaussians spanning at most 4x4 tiles (n/64 slots, at least
    4096); 2b, the 8x8 grid of the others (n/256 slots, at least 2048).
    Ids past n address rows [big4; big8; mid] appended to the n originals."""
    dev = means2d.device
    n = means2d.shape[0]
    tx, ty = -(-width // TILE), -(-height // TILE)
    t_total = tx * ty
    tile_bits = max(1, t_total.bit_length())
    shift = 32 - tile_bits
    valid = radii > 0
    rank_u = (torch.clamp_min(depths.float(), 1e-20).view(torch.int32).to(torch.int64)
              >> tile_bits)
    mx, my = means2d[:, 0], means2d[:, 1]
    x0 = torch.clamp(torch.floor((mx - radii) / TILE), 0, tx - 1).to(torch.int64)
    x1 = torch.clamp(torch.floor((mx + radii) / TILE), 0, tx - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor((my - radii) / TILE), 0, ty - 1).to(torch.int64)
    y1 = torch.clamp(torch.floor((my + radii) / TILE), 0, ty - 1).to(torch.int64)
    big = valid & ((x1 - x0 > 1) | (y1 - y0 > 1))
    small = valid & ~big
    sentinel = t_total << shift

    def miss(gx, gy, r, ptx, pty):
        lo_x = ptx.to(torch.float32) * TILE - 0.5
        lo_y = pty.to(torch.float32) * TILE - 0.5
        ddx = torch.clamp_min(torch.maximum(lo_x - gx, gx - (lo_x + TILE)), 0.0)
        ddy = torch.clamp_min(torch.maximum(lo_y - gy, gy - (lo_y + TILE)), 0.0)
        return ddx * ddx + ddy * ddy > r * r

    k_exact = torch.sqrt(torch.clamp_min(
        2.0 * torch.log(torch.clamp_min(opacities * 255.0, 1e-6)), 0.0))
    r_cull = radii * torch.clamp_min(k_exact / 3.0, 1.0)

    cells = torch.arange(4, device=dev)
    px1, py1 = x0[:, None] + cells % 2, y0[:, None] + cells // 2
    live = small[:, None] & (px1 <= x1[:, None]) & (py1 <= y1[:, None])
    live &= ~miss(mx[:, None], my[:, None], r_cull[:, None], px1, py1)
    ranks = torch.cumsum(live.to(torch.int64), dim=1)
    n_live = ranks[:, 3]

    def rth_cell(r):
        return torch.argmax((live & (ranks == r)).to(torch.int32), dim=-1)

    def cell_tile(c, rows=slice(None)):
        return (y0[rows] + c // 2) * tx + (x0[rows] + c % 2)

    fits4 = (x1 - x0 <= 3) & (y1 - y0 <= 3)
    k4, k8 = min(max(n // 64, 4096), n), min(max(n // 256, 2048), n)
    big4_order, is4, rest4, _ = _compact(big & fits4, k4)
    big8_order, is8, rest8, _ = _compact(big & ~fits4, k8)
    overflow = rest4 | rest8

    cxt = torch.clamp(torch.floor(mx / TILE).to(torch.int64), 0, tx - 1)
    cyt = torch.clamp(torch.floor(my / TILE).to(torch.int64), 0, ty - 1)
    tile0 = torch.where(overflow, cyt * tx + cxt, cell_tile(rth_cell(1)))
    keys0 = torch.where((n_live >= 1) | overflow, (tile0 << shift) | rank_u, sentinel | rank_u)
    keys1a = torch.where(n_live >= 2, (cell_tile(rth_cell(2)) << shift) | rank_u,
                         sentinel | rank_u)
    km = min(max(n // 16, 8192), n)
    mid_order, is_mid, _, _ = _compact(n_live >= 3, km)
    rank_m = rank_u[mid_order]
    t3 = cell_tile(rth_cell(3)[mid_order], mid_order)
    t4 = cell_tile(rth_cell(4)[mid_order], mid_order)
    keys1b = torch.stack([
        torch.where(is_mid, (t3 << shift) | rank_m, sentinel | rank_m),
        torch.where(is_mid & (n_live[mid_order] >= 4), (t4 << shift) | rank_m,
                    sentinel | rank_m)], dim=1).reshape(-1)

    def grid_keys(order, is_slot, g):
        m = torch.arange(g * g, device=dev)
        pxg, pyg = x0[order][:, None] + m % g, y0[order][:, None] + m // g
        ok = is_slot[:, None] & (pxg <= x1[order][:, None]) & (pyg <= y1[order][:, None])
        ok &= ~miss(mx[order][:, None], my[order][:, None], r_cull[order][:, None], pxg, pyg)
        rk = rank_u[order][:, None]
        return torch.where(ok, ((pyg * tx + pxg) << shift) | rk, sentinel | rk).reshape(-1)

    keys = torch.cat([keys0, keys1a, keys1b, grid_keys(big4_order, is4, 4),
                      grid_keys(big8_order, is8, MAX_COVER)])
    sorted_keys, pid = torch.sort(keys, stable=True)
    tile = sorted_keys >> shift
    n1a, n1b = 2 * n, 2 * n + 2 * km
    n2a = n1b + 16 * k4
    gid = torch.where(pid < n, pid, torch.where(
        pid < n1a, pid - n, torch.where(
            pid < n1b, n + k4 + k8 + (pid - n1a) // 2, torch.where(
                pid < n2a, n + (pid - n1b) // 16, n + k4 + (pid - n2a) // (MAX_COVER ** 2)))))
    starts = torch.searchsorted(tile, torch.arange(t_total + 1, device=dev))
    pos = starts[:-1, None] + torch.arange(k_tile, device=dev)
    gvalid = pos < starts[1:, None]
    gidx = torch.cat([gid, torch.zeros(k_tile, dtype=torch.int64, device=dev)])[pos]
    return Binning(gidx, gvalid, mid_order, big4_order, big8_order)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16 rounding in the forward, identity in the backward."""
    return x + (x.to(torch.bfloat16).to(torch.float32) - x).detach()


def pack(means2d, conics, colors, opacities, depths, b: Binning) -> torch.Tensor:
    """(16, T, K) tile block: 0:2 mean | 2:5 conic | 5:8 rgb | 8 op | 9 depth,
    rounded to bf16 (the mean as hi + lo); empty slots are zero. The gradient
    reaching each slot is rounded to bf16 before it sums onto its gaussian."""
    hi = _round_bf16(means2d)
    mean = hi + _round_bf16(means2d - hi)
    feat = torch.cat([mean, _round_bf16(torch.cat(
        [conics, colors, opacities[:, None], depths[:, None]], dim=1))], dim=1)
    ext = torch.cat([feat, feat[b.big4_order], feat[b.big8_order], feat[b.mid_order],
                     torch.zeros_like(feat[:1])])
    idx = torch.where(b.gvalid, b.gidx, torch.full_like(b.gidx, ext.shape[0] - 1))
    t, k = idx.shape
    g = ext[idx.reshape(-1)]
    if g.requires_grad:
        g.register_hook(lambda d: d.to(torch.bfloat16).to(torch.float32))
    g = g.T.reshape(10, t, k)
    return torch.cat([g, g.new_zeros((C_PACK - 10, t, k))])


# ---------------------------------------------------------------- compositing

def composite_block(packed, counts, tile0, tx):
    """Plain compositing of tiles tile0 .. tile0 + T of packed (16, T, K):
    -> out (T, 5, P) with rows rgb, alpha = 1 - T_final, depth; and the
    chunks reached (T, K/128) bool."""
    _, t_n, k = packed.shape
    dev = packed.device
    blocks = packed.permute(1, 2, 0)
    tile = torch.arange(tile0, tile0 + t_n, device=dev)[:, None]
    lin = torch.arange(P, device=dev)[None, :]
    px = ((tile % tx) * TILE + lin % TILE).to(torch.float32) + 0.5
    py = ((tile // tx) * TILE + lin // TILE).to(torch.float32) + 0.5
    n_lim = torch.clamp_max((counts.to(torch.int64) + CHUNK - 1) // CHUNK, k // CHUNK)
    accum = packed.new_zeros((t_n, 3, P))
    depth = packed.new_zeros((t_n, P))
    trans = packed.new_ones((t_n, P))
    reached = []
    for c in range(k // CHUNK):
        on = (c < n_lim) & (trans.detach().amax(dim=1) > TERM_THRESHOLD)
        reached.append(on)
        blk = blocks[:, c * CHUNK:(c + 1) * CHUNK]
        dx = px[:, None, :] - blk[..., 0:1]
        dy = py[:, None, :] - blk[..., 1:2]
        sigma = 0.5 * (blk[..., 2:3] * dx * dx + blk[..., 4:5] * dy * dy) + blk[..., 3:4] * dx * dy
        raw = blk[..., 8:9] * torch.exp(-torch.clamp_min(sigma, 0.0))
        live = (sigma >= 0.0) & (raw >= ALPHA_THRESHOLD)
        alpha = torch.where(live, torch.clamp_max(raw, MAX_ALPHA), torch.zeros_like(raw))
        cum = torch.cumprod(1.0 - alpha, dim=1)
        t_within = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        w = alpha * t_within * trans[:, None, :] * on[:, None, None]
        accum = accum + einsum("tkp,tkc->tcp", w, blk[..., 5:8])
        depth = depth + torch.sum(w * blk[..., 9:10], dim=1)
        trans = torch.where(on[:, None], trans * cum[:, -1], trans)
    out = torch.cat([accum, (1.0 - trans)[:, None], depth[:, None]], dim=1)
    return out, torch.stack(reached, dim=1)


def composite_all(packed, counts, tx):
    """composite_block over all tiles, a block at a time: (out, reached)."""
    outs, reached = [], []
    for t0 in range(0, packed.shape[1], BLOCK_TILES):
        o, r = composite_block(packed[:, t0:t0 + BLOCK_TILES], counts[t0:t0 + BLOCK_TILES],
                               t0, tx)
        outs.append(o)
        reached.append(r)
    return torch.cat(outs), torch.cat(reached)


class _Composite(torch.autograd.Function):
    """composite_all, whose backward recomputes each block's forward under
    autograd and backpropagates that block's part of the output gradient."""

    @staticmethod
    def forward(ctx, packed, counts, tx):
        ctx.save_for_backward(packed, counts)
        ctx.tx = tx
        return composite_all(packed, counts, tx)[0]

    @staticmethod
    def backward(ctx, gout):
        packed, counts = ctx.saved_tensors
        dpacked = torch.zeros_like(packed)
        for t0 in range(0, packed.shape[1], BLOCK_TILES):
            with torch.enable_grad():
                blk = packed[:, t0:t0 + BLOCK_TILES].detach().requires_grad_(True)
                o, _ = composite_block(blk, counts[t0:t0 + BLOCK_TILES], t0, ctx.tx)
                (d,) = torch.autograd.grad(o, blk, gout[t0:t0 + BLOCK_TILES])
            dpacked[:, t0:t0 + BLOCK_TILES] = d
        return dpacked, None, None


class Render(NamedTuple):
    color: torch.Tensor      # (H, W, 3)
    means2d: torch.Tensor    # (N, 2): its gradient is the densify gradient
    radii: torch.Tensor      # (N,) the render's radii (0 = not drawn)
    binning: Binning
    counts: torch.Tensor     # (T,) pairs each tile keeps
    reached: Optional[torch.Tensor]  # (T, K/128) chunks the sweep reached (no_grad only)


def render(means, log_scales, quats, opacity_logits, sh0, shN, viewmat, intrin,
           width, height, sh_degree, k_tile, background=None, antialiased=False,
           alive=None, means2d_offset=None) -> Render:
    """One view. means2d_offset (N, 2 zeros) is added to the projected means,
    so that its gradient is the screen-space gradient densification reads."""
    fx, fy, cx, cy = (float(v) for v in intrin)
    op = torch.sigmoid(opacity_logits)
    proj = project(means, log_scales, quats, viewmat, fx, fy, cx, cy, width, height,
                   antialiased=antialiased, opacities=op)
    means2d = proj.means2d if means2d_offset is None else proj.means2d + means2d_offset
    cam_pos = -mm(viewmat[:3, :3].T, viewmat[:3, 3:4])[:, 0]
    dirs = means - cam_pos
    dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-12)
    colors = sh_color(sh0, shN, dirs, sh_degree)
    opacities = op * proj.compensations
    radii = proj.radii if alive is None else torch.where(alive, proj.radii,
                                                         torch.zeros_like(proj.radii))
    b = bin_tiles(means2d.detach(), proj.depths.detach(), radii, opacities.detach(),
                  width, height, k_tile)
    packed = pack(means2d, proj.conics, colors, opacities, proj.depths, b)
    counts = b.gvalid.sum(dim=1)
    tx, ty = -(-width // TILE), -(-height // TILE)
    if torch.is_grad_enabled():
        out, reached = _Composite.apply(packed, counts, tx), None
    else:
        out, reached = composite_all(packed, counts, tx)
    color = out[:, 0:3].transpose(1, 2)
    if background is not None:
        color = color + (1.0 - out[:, 3])[..., None] * background
    img = color.reshape(ty, tx, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(ty * TILE, tx * TILE, 3)[:height, :width]
    return Render(img, means2d, radii, b, counts, reached)
