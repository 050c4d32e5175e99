"""The yardstick's arithmetic: the H100's peaks, the bytes and f32 operations
a compositing launch needs, and the f32 operations a training step needs.

Work is counted from the plain reference's equations and the inputs, never
from what the program happens to execute: dead slots, recomputation and
layout copies are not work.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit: HBM3 bytes/s
# and f32 operations/s outside the tensor cores (the program computes in
# f32 with TF32 off).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

CHUNK, P, C_PACK = 128, 256, 16
# f32 operations per (pixel, gaussian) pair. Forward: offsets 2, sigma 9,
# exp/clamp/threshold 8, weight 1, rgb + depth accumulation 8,
# transmittance 2. Backward: the same 17 to recompute alpha, e and dalpha
# 14, the conic/mean chain 8, the 10 gradient terms 15, the suffix 2, and 10
# adds for the 256-pixel reduction of the 10 channels.
FWD_OPS_PER_PAIR = 30
BWD_OPS_PER_PAIR = 66

# f32 operations per live gaussian a step, counted from reference/render.py
# and reference/train.py. Projection forward: camera transform 18, tangent
# clamp 8, quaternion to rotation 53, W R S 57, its covariance 45, the
# Jacobian 10, cov2d 29, determinant, blur and compensation 13, conic 5,
# means2d 8, extent and culling 32: 278; it runs twice (the render's pose
# with its delta, and the visibility pose), and its backward takes about
# 500. Opacity sigmoid 4 + 3.
PROJECTION_OPS = 2 * 278 + 500 + 7
# SH colour: view direction 13, + 9 for the offset and clip, the basis
# (0, 3, 15, 50 operations for degrees 0..3), 6 per coefficient set
# (3 multiplies, 3 adds); the backward the same per coefficient, the basis
# again and 20 back to the means.
SH_BASIS_OPS = (0, 3, 15, 50)
# Adam per parameter element: g^2 1, two moments 6, bias corrections 2,
# sqrt, eps and divide 3, the lr 1, the update 1, the alive mask 1.
ADAM_OPS_PER_ELEMENT = 15
# the densify accumulator per gaussian: NDC scale 2, norm 4, mask and sums 3
DENSIFY_OPS = 9
# per pixel: L1 (3 channels, 5 a channel forward and backward) and SSIM (a
# channel: 3 products, 5 maps blurred by 2 passes of 11 taps = 210, 22 of
# map arithmetic; backward 3 transposed blurs = 126 and 44 of arithmetic),
# and the background blend 9.
PIXEL_OPS = 3 * 5 + 3 * (3 + 210 + 22 + 126 + 44) + 9


def sh_ops(degree: int) -> int:
    n = (degree + 1) ** 2 - 1
    basis = SH_BASIS_OPS[degree]
    return (22 + basis + 6 * n) + (6 * n + basis + 20)


def composite_work(counts, reached, k: int) -> dict:
    """Work of one forward and one backward launch on a packed view: counts
    (T,) pairs each tile keeps, reached (T, K/128) chunks the sweep reached
    (a prefix of each tile's). The pairs are the real ones in reached
    chunks; each input byte is counted once and each output byte once."""
    t_total = int(counts.shape[0])
    n_chunks = k // CHUNK
    n_reached = int(reached.sum())
    reached_slots = reached.sum(dim=1) * CHUNK
    pairs = int(counts.long().minimum(reached_slots).sum()) * P
    chunk_bytes = n_reached * CHUNK * 10 * 4
    fwd_bytes = (chunk_bytes + t_total * 4 + t_total * 8 * P * 4
                 + t_total * n_chunks * P * 4)
    bwd_bytes = (chunk_bytes + t_total * 5 * P * 4 + t_total * n_chunks * P * 4
                 + t_total * P * 4 + C_PACK * t_total * k * 4)
    return {"pairs": pairs, "fwd_bytes": fwd_bytes, "bwd_bytes": bwd_bytes,
            "fwd_ops": pairs * FWD_OPS_PER_PAIR, "bwd_ops": pairs * BWD_OPS_PER_PAIR}


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of its two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def step_ops(alive: int, elements_per_row: int, pixels: int, pairs: float,
             sh_degree: int) -> float:
    """f32 operations one training step needs on one view."""
    per_row = (PROJECTION_OPS + sh_ops(sh_degree) + DENSIFY_OPS
               + ADAM_OPS_PER_ELEMENT * elements_per_row)
    return (alive * per_row + pixels * PIXEL_OPS
            + pairs * (FWD_OPS_PER_PAIR + BWD_OPS_PER_PAIR))
