"""Parity of the port's projection, SH decode, rasterizer and full render (with
gradients) with the JAX reference, on the CPU. Inputs come from numpy with fixed seeds."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_splat.gs import projection as jproj
from tpu_splat.gs import rasterize as jras
from tpu_splat.gs import render as jrend
from tpu_splat.gs import sh as jsh
from tpu_splat_torch.gs import projection as tproj
from tpu_splat_torch.gs import rasterize as tras
from tpu_splat_torch.gs import render as trend
from tpu_splat_torch.gs import sh as tsh
from tpu_splat_torch.testing import look_at

torch.set_num_threads(1)

W, H, FX = 64, 48, 60.0
RASTER_BG = np.array([0.1, 0.2, 0.3], np.float32)


def max_rel(ref, got):
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(ref - np.asarray(got, np.float32))) / (np.max(np.abs(ref)) + 1e-12))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    n = 300
    p = {
        "means": rng.uniform(-1, 1, (n, 3)),
        "scales": np.log(rng.uniform(0.02, 0.15, (n, 3))),
        "quats": np.concatenate([np.ones((n, 1)), 0.3 * rng.standard_normal((n, 3))], 1),
        "opacities": rng.normal(0, 1.5, n),
        "sh0": rng.normal(0, 0.5, (n, 3)),
        "shN": rng.normal(0, 0.1, (n, 15, 3)),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    alive = rng.uniform(size=n) < 0.9
    return p, alive, look_at(np.array([3.0, 0.5, 2.0])), rng


@pytest.fixture(scope="module")
def raster_inputs():
    """400 screen-space gaussians over a 64x48 image, with a weight image for
    the loss (the rasterize test's inputs)."""
    rng = np.random.default_rng(2)
    n = 400
    m2d = np.stack([rng.uniform(-5, W + 5, n), rng.uniform(-5, H + 5, n)], 1).astype(np.float32)
    sc = rng.uniform(1.5, 6, n)
    conics = np.stack([1 / sc**2, rng.uniform(-0.1, 0.1, n) / sc**2,
                       1 / (sc * rng.uniform(0.6, 1.4, n)) ** 2], 1).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    op = rng.uniform(0.05, 0.95, n).astype(np.float32)
    depths = rng.uniform(0.5, 10, n).astype(np.float32)
    radii = np.ceil(3 * sc * 1.4).astype(np.float32)
    wimg = rng.standard_normal((H, W, 3)).astype(np.float32)
    return (m2d, conics, colors, op, depths), radii, wimg


@pytest.fixture(scope="module")
def reference(scene, raster_inputs):
    """The JAX package's outputs and gradients for the projection, render_view
    and rasterize tests below, from one jit: each test's loss depends on its
    own arguments only, so one value_and_grad of their sum gives every
    gradient, for one XLA compile in place of three."""
    p, alive, vm, rng = scene
    n = p["means"].shape[0]
    op = 1.0 / (1.0 + np.exp(-p["opacities"]))
    wm = rng.standard_normal((n, 2)).astype(np.float32)
    wc = rng.standard_normal((n, 3)).astype(np.float32)
    wimg = rng.standard_normal((H, W, 3)).astype(np.float32)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    ras_in, radii, ras_w = raster_inputs

    def project_loss(means, scales, quats):
        pr = jproj.project_gaussians(means, scales, quats, vm, FX, FX, W / 2, H / 2, W, H,
                                     antialiased=True, opacities=op)
        return jnp.sum(pr.means2d * wm) + jnp.sum(pr.conics * wc), pr

    def render_loss(pp, dummy):
        out = jrend.render_view(
            pp["means"], pp["scales"], pp["quats"], pp["opacities"], pp["sh0"], pp["shN"],
            vm, FX, FX, W / 2, H / 2, W, H, sh_degree=3, background=bg, max_per_tile=256,
            means2d_dummy=dummy, alive=alive)
        return jnp.sum(out.color * wimg) + jnp.sum(out.alpha * wimg[..., 0]), out

    def raster_loss(m, c, col, o, d):
        out = jras.rasterize(m, c, col, o, d, radii, W, H, background=RASTER_BG,
                             max_per_tile=256)
        return (jnp.sum(out.color * ras_w) + jnp.sum(out.alpha * ras_w[..., 0])
                + jnp.sum(out.depth * ras_w[..., 1])), out

    def total(proj_in, pp, dummy, r_in):
        lp, pj = project_loss(*proj_in)
        lr, oj = render_loss(pp, dummy)
        lz, oz = raster_loss(*r_in)
        return lp + lr + lz, (pj, oj, oz)

    proj_in = (p["means"], p["scales"], p["quats"])
    (_, (pj, oj, oz)), (g_proj, g_render, g_dummy, g_raster) = jax.jit(
        jax.value_and_grad(total, argnums=(0, 1, 2, 3), has_aux=True))(
        proj_in, p, np.zeros((n, 2), np.float32), ras_in)
    return dict(weights=(wm, wc, wimg, bg, op), project=(pj, g_proj),
                render=(oj, g_render, g_dummy), raster=(oz, g_raster))


def test_project_gaussians_matches_reference(scene, reference):
    """means2d/conics/depths/compensations (antialiased, so the mip
    compensation is live) to 1e-5 of scale (f32 op order: the port forms the
    camera covariance as one 3x3 product), radii equal (integers from ceil),
    and the means2d + conics gradients to 1e-4 of scale."""
    p, _, vm, _ = scene
    wm, wc, _, _, op = reference["weights"]
    pj, gj = reference["project"]
    ins = [torch.from_numpy(p[k]).requires_grad_(True) for k in ("means", "scales", "quats")]
    pt = tproj.project_gaussians(*ins, torch.from_numpy(vm), FX, FX, W / 2, H / 2, W, H,
                                 antialiased=True, opacities=torch.from_numpy(op))
    ((pt.means2d * torch.from_numpy(wm)).sum() + (pt.conics * torch.from_numpy(wc)).sum()
     ).backward()
    for name in ("means2d", "conics", "depths", "compensations"):
        assert max_rel(getattr(pj, name), getattr(pt, name).detach().numpy()) <= 1e-5, name
    assert np.array_equal(np.asarray(pj.radii), pt.radii.numpy())
    for g_ref, x in zip(gj, ins):
        assert max_rel(g_ref, x.grad.numpy()) <= 1e-4


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_to_color_matches_reference(scene, degree):
    """Colors to 1e-6 abs and gradients to 1e-5 of scale (f32 op order)."""
    p, _, _, rng = scene
    dirs = rng.standard_normal((p["sh0"].shape[0], 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    wcol = rng.standard_normal(p["sh0"].shape).astype(np.float32)

    def jf(sh0, shN):
        c = jsh.sh_to_color(sh0, shN, dirs, degree)
        return jnp.sum(c * wcol), c

    (_, cj), gj = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        p["sh0"], p["shN"])
    sh0, shN = (torch.from_numpy(p[k]).requires_grad_(True) for k in ("sh0", "shN"))
    ct = tsh.sh_to_color(sh0, shN, torch.from_numpy(dirs), degree)
    (ct * torch.from_numpy(wcol)).sum().backward()
    assert float(np.max(np.abs(np.asarray(cj) - ct.detach().numpy()))) <= 1e-6
    assert max_rel(gj[0], sh0.grad.numpy()) <= 1e-5
    # degree 0 never reads shN: JAX returns a zero gradient, torch none
    g_shN = shN.grad.numpy() if shN.grad is not None else np.zeros_like(p["shN"])
    assert np.array_equal(np.asarray(gj[1]) == 0, g_shN == 0)
    assert max_rel(gj[1], g_shN) <= 1e-5


def test_render_view_matches_reference(scene, reference):
    """Image/alpha/depth and gradients for every parameter and the
    means2d_dummy screen gradient. Last-bit f32 differences in the projected
    inputs can flip a bf16 rounding of the pack (2^-8 relative on one
    value), so the bars are 1e-4 abs on the image, 5e-4 abs on depth and
    1e-3 of the gradient scale."""
    p, alive, vm, _ = scene
    _, _, wimg, bg, _ = reference["weights"]
    oj, gp, gd = reference["render"]
    n = p["means"].shape[0]
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    dummy = torch.zeros((n, 2), requires_grad=True)
    ot = trend.render_view(
        tp["means"], tp["scales"], tp["quats"], tp["opacities"], tp["sh0"], tp["shN"],
        torch.from_numpy(vm), FX, FX, W / 2, H / 2, W, H, sh_degree=3,
        background=torch.from_numpy(bg), max_per_tile=256, means2d_dummy=dummy,
        alive=torch.from_numpy(alive), device="cpu")
    wt = torch.from_numpy(wimg)
    ((ot.color * wt).sum() + (ot.alpha * wt[..., 0]).sum()).backward()
    assert float(np.max(np.abs(np.asarray(oj.color) - ot.color.detach().numpy()))) <= 1e-4
    assert float(np.max(np.abs(np.asarray(oj.alpha) - ot.alpha.detach().numpy()))) <= 1e-4
    assert float(np.max(np.abs(np.asarray(oj.depth) - ot.depth.detach().numpy()))) <= 5e-4
    for k in p:
        assert max_rel(gp[k], tp[k].grad.numpy()) <= 1e-3, k
    assert max_rel(gd, dummy.grad.numpy()) <= 1e-3
    assert np.max(np.abs(np.asarray(gd))) > 0


def test_rasterize_matches_reference(raster_inputs, reference):
    """Image, alpha and depth, and gradients into all five per-gaussian inputs
    through the bf16 pack gather. Both sides round the pack to bf16 and route
    gradients through bf16, so they agree to f32 summation order: 1e-5 abs on
    the image, 1e-4 of the gradient scale."""
    ras_in, radii, wimg = raster_inputs
    oj, gj = reference["raster"]
    ins = [torch.from_numpy(a).requires_grad_(True) for a in ras_in]
    ot = tras.rasterize(*ins, torch.from_numpy(radii), W, H,
                        background=torch.from_numpy(RASTER_BG), max_per_tile=256, device="cpu")
    wt = torch.from_numpy(wimg)
    ((ot.color * wt).sum() + (ot.alpha * wt[..., 0]).sum()
     + (ot.depth * wt[..., 1]).sum()).backward()
    assert float(np.max(np.abs(np.asarray(oj.color) - ot.color.detach().numpy()))) <= 1e-5
    assert float(np.max(np.abs(np.asarray(oj.alpha) - ot.alpha.detach().numpy()))) <= 1e-5
    assert float(np.max(np.abs(np.asarray(oj.depth) - ot.depth.detach().numpy()))) <= 1e-5
    for name, g_ref, x in zip(["means2d", "conics", "colors", "opacities", "depths"], gj, ins):
        assert max_rel(g_ref, x.grad.numpy()) <= 1e-4, name


def test_render_cloud_matches_render_view(scene):
    """render_cloud is render_view through one camera of a Cameras batch."""
    from tpu_splat_torch.core.types import Cameras, GaussianCloud

    p, _, vm, _ = scene
    cloud = GaussianCloud(**p)
    cams = Cameras(camtoworlds=np.linalg.inv(vm)[None].astype(np.float32),
                   fx=np.array([FX], np.float32), fy=np.array([FX], np.float32),
                   cx=np.array([W / 2], np.float32), cy=np.array([H / 2], np.float32),
                   distortion=np.zeros((1, 4), np.float32), width=W, height=H)
    a = trend.render_cloud(cloud, cams, 0, background=torch.zeros(3), device="cpu")
    b = trend.render_view(*(torch.from_numpy(p[k]) for k in
                            ("means", "scales", "quats", "opacities", "sh0", "shN")),
                          torch.from_numpy(cams.worldtocams[0]), FX, FX, W / 2, H / 2, W, H,
                          background=torch.zeros(3), device="cpu")
    assert torch.equal(a.color, b.color) and torch.equal(a.depth, b.depth)
