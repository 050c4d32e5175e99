"""Parity of the port's losses, Adam and densification with the JAX reference,
on the CPU. Inputs come from numpy with fixed seeds; state crosses between the
packages through tpu_splat_torch.convert."""

import numpy as np
import jax
import pytest
import jax.numpy as jnp
import torch

from tpu_splat.gs import losses as jloss
from tpu_splat.gs import optim as joptim
from tpu_splat.gs import strategy as jstrat
from tpu_splat_torch import convert
from tpu_splat_torch.gs import losses as tloss
from tpu_splat_torch.gs import optim as toptim
from tpu_splat_torch.gs import strategy as tstrat

torch.set_num_threads(1)


def max_rel(ref, got):
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(ref - np.asarray(got, np.float32))) / (np.max(np.abs(ref)) + 1e-12))


def random_params(rng, n, alive_frac=0.6):
    p = {
        "means": rng.uniform(-1, 1, (n, 3)),
        # mostly below the split threshold (dups), some above (splits), a few
        # giants above the prune threshold
        "scales": np.log(rng.uniform(0.002, 0.04, (n, 3))
                         * np.where(rng.uniform(size=(n, 1)) < 0.05, 10.0, 1.0)),
        "quats": np.concatenate([np.ones((n, 1)), 0.3 * rng.standard_normal((n, 3))], 1),
        "opacities": rng.normal(-1.0, 2.5, n),
        "sh0": rng.normal(0, 0.5, (n, 3)),
        "shN": rng.normal(0, 0.1, (n, 15, 3)),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    p["alive"] = rng.uniform(size=n) < alive_frac
    return p


def test_ssim_and_image_loss_match_reference():
    """Banded-matrix SSIM in full f32 on both sides: 1e-6 abs on the values,
    1e-4 of the gradient scale (summation order of the band products)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    (lj, sj), gj = jax.jit(jax.value_and_grad(
        lambda x: (jloss.image_loss(x, b), jloss.ssim(x, b)), has_aux=True))(a)
    sj = float(sj)
    ta = torch.from_numpy(a).requires_grad_(True)
    st = tloss.ssim(ta, torch.from_numpy(b))
    lt = tloss.image_loss(ta, torch.from_numpy(b))
    lt.backward()
    assert abs(sj - float(st.detach())) <= 1e-6
    assert abs(float(lj) - float(lt.detach())) <= 1e-6
    assert max_rel(gj, ta.grad.numpy()) <= 1e-4
    assert abs(float(jloss.psnr(a, b)) - float(tloss.psnr(torch.from_numpy(a),
                                                          torch.from_numpy(b)))) <= 1e-4


@pytest.mark.parametrize("masked", [False, True], ids=["every_row", "grad_mask"])
def test_adam_update_matches_reference(masked):
    """Two selective-Adam steps from nonzero moments. Parameters and the f32
    second moment to 1e-6 of scale (f32 op order); the bf16 shN first moment
    to one bf16 ulp (an f32 last-bit difference can flip its rounding). With
    grad_mask the reference gets the gradients zeroed on dead rows, as its
    trainer does, and the port's masked update equals its torch.where then
    update bit for bit."""
    rng = np.random.default_rng(1)
    n = 96
    p = random_params(rng, n)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    state = joptim.adam_init(jp)
    grads = {k: jnp.asarray(rng.normal(0, 1, v.shape).astype(np.float32))
             for k, v in p.items() if k != "alive"}
    lrs = {"means": 1e-3, "scales": 5e-3, "quats": 1e-3, "opacities": 5e-2,
           "sh0": 2.5e-3, "shN": 1.25e-4}
    visible = rng.uniform(size=n) < 0.7
    if masked:
        grads_j = {k: jnp.where(p["alive"].reshape((-1,) + (1,) * (v.ndim - 1)), v, 0.0)
                   for k, v in grads.items()}
    else:
        grads_j = grads
    jupd = jax.jit(lambda pp, st, g: joptim.adam_update(pp, g, st, lrs, visible=visible))
    jp1, st1 = jupd(jp, state, grads_j)
    jp2, st2 = jupd(jp1, st1, {k: -0.5 * v for k, v in grads_j.items()})

    tp = convert.params_to_torch(p, "cpu")
    tstate = toptim.adam_init(tp)
    tg = convert.params_to_torch({k: np.asarray(v) for k, v in grads.items()}, "cpu")
    vis = torch.from_numpy(visible)
    mask = tp["alive"] if masked else None
    tp1, ts1 = toptim.adam_update(tp, tg, tstate, lrs, visible=vis, grad_mask=mask)
    tp2, ts2 = toptim.adam_update(tp1, {k: -0.5 * v for k, v in tg.items()}, ts1, lrs,
                                  visible=vis, grad_mask=mask)
    if masked:
        def where(g):
            return {k: torch.where(mask.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                                   torch.zeros_like(v)) for k, v in g.items()}

        wp1, ws1 = toptim.adam_update(tp, where(tg), tstate, lrs, visible=vis)
        wp2, ws2 = toptim.adam_update(wp1, where({k: -0.5 * v for k, v in tg.items()}), ws1,
                                      lrs, visible=vis)
        for k in grads:
            assert torch.equal(tp2[k], wp2[k]), k
            assert torch.equal(ts2.mu[k], ws2.mu[k]) and torch.equal(ts2.nu[k], ws2.nu[k]), k

    assert ts2.mu["shN"].dtype == torch.bfloat16 and st2.mu["shN"].dtype == jnp.bfloat16
    assert int(ts2.count) == int(st2.count) == 2
    mu_np, nu_np, _ = convert.adam_to_numpy(ts2)
    for k in grads:
        assert max_rel(jp2[k], tp2[k].numpy()) <= 1e-6, k
        assert max_rel(st2.nu[k], nu_np[k]) <= 1e-6, k
        tol = 2.0**-8 if k == "shN" else 1e-6
        assert max_rel(np.asarray(st2.mu[k]).astype(np.float32), mu_np[k]) <= tol, k
        # hidden rows are untouched
        assert np.array_equal(tp2[k].numpy()[~visible], p[k][~visible]), k
    # reset_slots zeroes the same rows on both sides
    mask = rng.uniform(size=n) < 0.3
    rj = joptim.reset_slots(st2, jnp.asarray(mask))
    rt = toptim.reset_slots(ts2, torch.from_numpy(mask))
    for k in grads:
        assert np.array_equal(np.asarray(rj.nu[k]) == 0, rt.nu[k].numpy() == 0), k


def test_refine_matches_reference_masks_counts_and_unsplit_rows():
    """Split offsets are random draws (jax.random vs torch.Generator), so the
    comparison is on what does not depend on them: the stats, the alive mask,
    every row that is not a split parent or child (exact), the children's
    shrunk scales (1e-6: log(1.6) rounding), and which Adam rows were reset."""
    rng = np.random.default_rng(2)
    n = 256
    p = random_params(rng, n, alive_frac=0.55)
    grad_accum = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0, 1e-3, n), 0).astype(np.float32)
    count_accum = np.where(grad_accum > 0, rng.integers(1, 4, n), 0).astype(np.float32)
    cfg = jstrat.DensifyConfig()
    scene_scale, step = 2.0, 4000  # past the first reset, so giants prune too

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jadam = joptim.adam_init(jp)
    jadam = jadam._replace(nu={k: jnp.ones_like(v) for k, v in jadam.nu.items()})
    jd = jstrat.DensifyState(jnp.asarray(grad_accum), jnp.asarray(count_accum))
    np_j, adam_j, _, stats_j = jstrat.refine(jp, jadam, jd, jax.random.PRNGKey(0),
                                             jnp.asarray(scene_scale), cfg, jnp.asarray(step))

    tp = convert.params_to_torch(p, "cpu")
    tadam = toptim.adam_init(tp)
    tadam = tadam._replace(nu={k: torch.ones_like(v) for k, v in tadam.nu.items()})
    td = tstrat.DensifyState(torch.from_numpy(grad_accum), torch.from_numpy(count_accum))
    gen = torch.Generator().manual_seed(0)
    tcfg = tstrat.DensifyConfig()
    np_t, adam_t, dstate_t, stats_t = tstrat.refine(tp, tadam, td, gen, scene_scale, tcfg, step)

    for k in ("n_split", "n_dup", "n_pruned", "n_alive"):
        assert int(stats_j[k]) == int(stats_t[k]), k
    assert int(stats_t["n_split"]) > 0 and int(stats_t["n_dup"]) > 0
    assert int(stats_t["n_pruned"]) > 0
    alive_j = np.asarray(np_j["alive"])
    assert np.array_equal(alive_j, np_t["alive"].numpy())

    # rows whose means came from a random offset differ by design
    moved_means = np.any(np.asarray(np_j["means"]) != p["means"], axis=1)
    for k in ("means", "scales", "quats", "opacities", "sh0", "shN"):
        a, b = np.asarray(np_j[k]), np_t[k].numpy()
        same = ~moved_means
        assert np.array_equal(a[same], b[same]), k
    changed_scales = np.any(np.asarray(np_j["scales"]) != p["scales"], axis=1)
    assert max_rel(np.asarray(np_j["scales"])[changed_scales],
                   np_t["scales"].numpy()[changed_scales]) <= 1e-6
    reset_j = np.asarray(adam_j.nu["means"])[:, 0] == 0
    assert np.array_equal(reset_j, adam_t.nu["means"].numpy()[:, 0] == 0)
    assert float(dstate_t.grad_accum.abs().sum()) == 0.0

    # the periodic opacity reset clamps logits and clears their moments
    rj, aj = jstrat.reset_opacity(np_j, adam_j, 0.01)
    rt, at = tstrat.reset_opacity(np_t, adam_t, 0.01)
    assert np.array_equal(np.asarray(rj["opacities"])[alive_j], rt["opacities"].numpy()[alive_j])
    assert float(at.nu["opacities"].abs().sum()) == 0.0


def test_mcmc_relocation_matches_reference_masks():
    """relocate_and_grow draws its sources at random (jax.random vs
    torch.Generator): both sides must fill the same target slots, copy live
    opaque rows into them, leave every other row's geometry alone and reset
    the moved slots' moments; add_noise must leave dead slots untouched."""
    from tpu_splat.gs import mcmc as jmcmc
    from tpu_splat_torch.gs import mcmc as tmcmc

    rng = np.random.default_rng(3)
    n = 256
    p = random_params(rng, n, alive_frac=0.5)
    cfg = jmcmc.MCMCConfig()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    pj, _ = jmcmc.relocate_and_grow(jp, joptim.adam_init(jp), jax.random.PRNGKey(0), cfg)
    tp = convert.params_to_torch(p, "cpu")
    tadam = toptim.adam_init(tp)
    tadam = tadam._replace(nu={k: torch.ones_like(v) for k, v in tadam.nu.items()})
    gen = torch.Generator().manual_seed(0)
    pt, at = tmcmc.relocate_and_grow(tp, tadam, gen, tmcmc.MCMCConfig())

    assert np.array_equal(np.asarray(pj["alive"]), pt["alive"].numpy())
    op = 1.0 / (1.0 + np.exp(-p["opacities"]))
    target = (p["alive"] & (op < cfg.min_opacity)) | (~p["alive"] & (
        np.cumsum(~p["alive"]) - 1 < int(n * cfg.grow_fraction)))
    assert target.sum() > 0
    sources = p["means"][p["alive"] & (op >= cfg.min_opacity)]
    for row in pt["means"].numpy()[target]:
        assert np.any(np.all(sources == row, axis=1))
    for k in ("means", "scales", "quats", "sh0", "shN"):
        assert np.array_equal(pt[k].numpy()[~target], p[k][~target]), k
    assert float(at.nu["means"][torch.from_numpy(target)].abs().sum()) == 0.0

    noisy = tmcmc.add_noise(pt, gen, 1e-4, tmcmc.MCMCConfig())
    dead = ~pt["alive"]
    assert torch.equal(noisy["means"][dead], pt["means"][dead])
    assert torch.isfinite(noisy["means"]).all()
    assert not torch.equal(noisy["means"][~dead], pt["means"][~dead])
