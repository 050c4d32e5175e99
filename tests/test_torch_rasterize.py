"""Parity of the port's tile binning (tpu_splat_torch.gs.rasterize) and
compositing (cuda_raster) with the JAX reference, on the CPU. The whole
rasterizer is held to the reference in test_torch_render.py.

On the CPU the JAX rasterizer composites through `composite_tiles_reference`
and differentiates it with autodiff; the port runs the plain versions of its
CUDA kernels (forward and explicit analytic backward). Inputs come from numpy
with fixed seeds and go to both packages unchanged.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scripts import check_kernel_parity
from tpu_splat.gs import pallas_raster as jpr
from tpu_splat.gs import rasterize as jras
from tpu_splat_torch.gs import cuda_raster as cr
from tpu_splat_torch.gs import rasterize as tras
from tpu_splat_torch.testing import build_packed

torch.set_num_threads(1)

TX, TY, TS = 4, 3, 16


def max_rel(ref, got):
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(ref - np.asarray(got, np.float32))) / (np.max(np.abs(ref)) + 1e-12))


def binning_load():
    """A load that overflows K, the corner-crosser tier and the 4x4 big tier
    (256x128, K=256): corner-crossers (small gaussians centred near a tile
    corner), bigs spanning 3-4 tiles, and free ones, some culled."""
    rng = np.random.default_rng(5)
    w, h = 256, 128
    n_mid, n_big, n_free = 9000, 7000, 500
    corners = np.stack([rng.integers(1, w // TS, n_mid) * TS,
                        rng.integers(1, h // TS, n_mid) * TS], 1)
    m_mid = corners + rng.uniform(-1.5, 1.5, (n_mid, 2))
    r_mid = np.full(n_mid, 3.0)
    m_big = np.stack([rng.uniform(0, w, n_big), rng.uniform(0, h, n_big)], 1)
    r_big = rng.uniform(17, 24, n_big)
    m_free = np.stack([rng.uniform(-20, w + 20, n_free), rng.uniform(-20, h + 20, n_free)], 1)
    r_free = np.where(rng.uniform(size=n_free) < 0.8, rng.uniform(1, 70, n_free), 0.0)
    means2d = np.concatenate([m_mid, m_big, m_free]).astype(np.float32)
    radii = np.ceil(np.concatenate([r_mid, r_big, r_free])).astype(np.float32)
    n = means2d.shape[0]
    depths = rng.uniform(0.2, 20.0, n).astype(np.float32)
    opac = rng.uniform(0.005, 1.0, n).astype(np.float32)
    return means2d, depths, radii, opac


@pytest.fixture(scope="module")
def packed_fixture():
    """check_kernel_parity's packed tensor (a near-empty tile, a tile that
    saturates in chunk 0, a tile that never saturates, mid-opacity content),
    a cotangent for it, and the reference composite and its jax.grad from
    one jit."""
    packed, counts = build_packed(np.random.default_rng(1), TX * TY, 2 * cr.CHUNK, TX, TS)
    ref_packed, ref_counts = check_kernel_parity.build_packed(
        np.random.default_rng(1), TX * TY, 2 * cr.CHUNK, TX, TS)
    assert np.array_equal(packed, np.asarray(ref_packed))
    assert np.array_equal(counts, np.asarray(ref_counts))
    cot = np.random.default_rng(2).standard_normal((TX * TY, 8, cr.P)).astype(np.float32)

    def f(p):
        out = jpr.composite_tiles_reference(p, TX, TY, TS)
        return jnp.sum(out * cot), out

    (_, out_ref), g_ref = jax.jit(jax.value_and_grad(f, has_aux=True))(packed)
    return packed, counts, np.asarray(out_ref), cot, np.asarray(g_ref)


def test_tile_gaussians_matches_reference():
    """Same gidx/gvalid per tile and the same overflow diagnostics, on a load
    that overflows K, the corner-crosser tier and the 4x4 big tier."""
    means2d, depths, radii, opac = binning_load()
    bj = jax.jit(lambda m, d, r, o: jras.tile_gaussians(m, d, r, 256, 128, TS, 256, opacities=o))(
        means2d, depths, radii, opac)
    bt = tras.tile_gaussians(*(torch.from_numpy(a) for a in (means2d, depths, radii)),
                             256, 128, TS, 256, opacities=torch.from_numpy(opac))
    # exact: integer binning, identical f32 cull arithmetic
    assert np.array_equal(np.asarray(bj.gvalid), bt.gvalid.numpy())
    assert np.array_equal(np.asarray(bj.gidx), bt.gidx.numpy())
    assert int(bj.mid_overflow) == int(bt.mid_overflow) > 0
    assert int(bj.big_overflow) == int(bt.big_overflow) > 0
    for name in ("mid_order", "big4_order", "big8_order"):
        assert np.array_equal(np.asarray(getattr(bj, name)), getattr(bt, name).numpy()), name


def test_plain_forward_matches_reference(packed_fixture):
    """Bar of check_kernel_parity: max abs 2e-5 (f32 cumprod vs sequential order)."""
    packed, counts, out_ref = packed_fixture[:3]
    out, tstart = cr.composite_tiles_plain(torch.from_numpy(packed), torch.from_numpy(counts),
                                           TX, TY)
    assert float(np.max(np.abs(out.numpy()[:, :5] - out_ref[:, :5]))) <= 2e-5
    assert np.all(out.numpy()[:, 5:] == 0)
    ts = tstart.numpy().reshape(TX * TY, -1, cr.P)
    # the near-empty tile (4 pairs) sweeps chunk 0 only; a full tile reaches both
    assert np.all(ts[1, 0] == 1.0) and np.all(ts[1, 1] == 0)
    assert np.max(ts[0, 1]) > 0


def test_counts_bounded_forward_is_bit_identical(packed_fixture):
    """Skipped chunks are all-sentinel (alpha exactly 0): bounding the sweep by
    the tile's pair count must not change one bit."""
    packed, counts = packed_fixture[:2]
    p = torch.from_numpy(packed)
    bounded, _ = cr.composite_tiles_plain(p, torch.from_numpy(counts), TX, TY)
    full, _ = cr.composite_tiles_plain(p, torch.full((TX * TY,), packed.shape[2]), TX, TY)
    assert torch.equal(bounded[:, :5], full[:, :5])


def test_plain_backward_matches_reference_grad_and_autograd(packed_fixture):
    """Analytic backward vs jax.grad of the reference and vs torch autograd of
    the plain forward: max |d| / max |g| <= 5e-5 (check_kernel_parity's bar;
    conic gradients reach 1e2-1e3 on tight splats, so the bar is relative)."""
    packed, counts, _, cot, g_ref = packed_fixture[:5]

    p = torch.from_numpy(packed).requires_grad_(True)
    c = torch.from_numpy(counts)
    out, tstart = cr.composite_tiles_plain(p, c, TX, TY)
    (out * torch.from_numpy(cot)).sum().backward()
    g_analytic = cr.composite_tiles_bwd_plain(
        p.detach(), torch.from_numpy(cot), tstart, 1.0 - out[:, 3].detach(), TX)
    assert max_rel(g_ref, g_analytic.numpy()) <= 5e-5
    assert max_rel(p.grad.numpy(), g_analytic.numpy()) <= 5e-5
    # the autograd.Function routes the CPU backward through the same function
    p2 = torch.from_numpy(packed).requires_grad_(True)
    (cr.composite_tiles(p2, c, TX, TY) * torch.from_numpy(cot)).sum().backward()
    assert torch.equal(p2.grad, g_analytic)
