"""Parity of the port's training loop, pipeline and exports with the JAX
reference, on the CPU: a short Trainer.run trajectory, train_splat end to end,
the image downscale, and the .ply/.spz bytes."""

import io
import re
from dataclasses import replace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_splat.core import ply as jply
from tpu_splat.core import spz as jspz
from tpu_splat.core import types as jtypes
from tpu_splat.gs import params as jparams
from tpu_splat.gs import pipeline as jpipe
from tpu_splat.gs import trainer as jtrainer
from tpu_splat_torch import convert
from tpu_splat_torch.core import ply as tply
from tpu_splat_torch.core import spz as tspz
from tpu_splat_torch.core import types as ttypes
from tpu_splat_torch.gs import params as tparams
from tpu_splat_torch.gs import pipeline as tpipe
from tpu_splat_torch.gs import trainer as ttrainer
from tpu_splat_torch.testing import synthetic_capture

torch.set_num_threads(1)

W, H = 64, 48
LOG_RE = re.compile(r"step (\d+): loss=([\d.]+) psnr=([\d.]+)")
# The training config of the two parity tests below: camera-pose optimisation
# on and random background off, so neither side draws random numbers, one
# 128-slot chunk per tile, and a log line after every step. train_splat gets
# it through TrainConfig.for_model, so the JAX side compiles its training step
# once for both tests (the compile is most of their time).
PARITY_CFG = dict(sh_degree=0, max_per_tile=128, warmup_max_per_tile=128,
                  random_background=False, eval_every=1, optimize_camera_poses=True)
MAX_STEPS = 10
# each Adam step moves a value by about its lr (1e-3 for quats); f32 rounding
# in near-zero gradients changes a step by a fraction of that
TOL_CLOUD = 5e-4


@pytest.fixture(scope="module")
def capture():
    """16 ring views (64x48) of 60 seeded gaussians, rendered by the port on
    the CPU, and a noisy sparse point cloud to start from."""
    return synthetic_capture()


@pytest.fixture
def parity_config(monkeypatch):
    """train_splat in both packages trains with PARITY_CFG, whatever the model."""
    for mod in (jtrainer, ttrainer):
        monkeypatch.setattr(
            mod.TrainConfig, "for_model",
            classmethod(lambda cls, model, max_steps=30000: cls(max_steps=max_steps,
                                                                **PARITY_CFG)))


def test_trainer_run_trajectory_matches_reference(capture):
    """Three Trainer.run steps on what train_splat trains (its 14 training
    views, capacity and scene scale): the logged loss/PSNR per step agree to
    their printed precision plus rounding, and the parameters after the run
    agree to 1e-4 abs (each Adam step moves a value by about its lr)."""
    viewmats, intrin, images, pts, colors = capture
    train = np.setdiff1d(np.arange(len(images)), jpipe.eval_split(len(images)))
    scene_scale = float(np.mean(np.linalg.norm(pts - pts.mean(0), axis=1))) * 1.1
    data = (images[train], viewmats[train], intrin[train])
    logs_j, logs_t = [], []
    jp = jparams.init_params_from_points(pts, colors, capacity=4096, sh_degree=0)
    jt = jtrainer.Trainer(jp, *data, scene_scale=scene_scale,
                          cfg=jtrainer.TrainConfig(max_steps=MAX_STEPS, **PARITY_CFG),
                          log_fn=logs_j.append)
    jt.run(3)
    tp = tparams.init_params_from_points(pts, colors, capacity=4096, sh_degree=0, device="cpu")
    tt = ttrainer.Trainer(tp, *data, scene_scale=scene_scale,
                          cfg=ttrainer.TrainConfig(max_steps=MAX_STEPS, **PARITY_CFG),
                          log_fn=logs_t.append, device="cpu")
    tt.run(3)

    traj_j = [LOG_RE.match(s).groups() for s in logs_j if LOG_RE.match(s)]
    traj_t = [LOG_RE.match(s).groups() for s in logs_t if LOG_RE.match(s)]
    assert len(traj_j) == len(traj_t) == 3
    for (sj, lj, pj), (st, lt, pt) in zip(traj_j, traj_t):
        assert sj == st
        assert abs(float(lj) - float(lt)) <= 2e-4
        assert abs(float(pj) - float(pt)) <= 0.02
    final = convert.params_to_numpy(tt.params)
    for k, v in jt.params.items():
        assert np.allclose(np.asarray(v), final[k], atol=1e-4, rtol=0), k
    assert np.allclose(np.asarray(jt.cam_deltas), tt.cam_deltas.numpy(), atol=1e-6)
    assert np.allclose(jt.adjusted_viewmats(), tt.adjusted_viewmats(), atol=1e-6)


def test_train_splat_matches_reference(capture, parity_config):
    """train_splat for 10 steps on a 16-view SfMScene (two held out), both
    sides on the parity config: the same number of gaussians, every
    parameter of the exported cloud within TOL_CLOUD abs, and held-out PSNR
    within 0.01 dB."""
    viewmats, intrin, images, pts, colors = capture
    c2w = np.linalg.inv(viewmats).astype(np.float32)
    n_img = images.shape[0]
    jscene = jtypes.SfMScene(
        cameras=jtypes.Cameras(camtoworlds=jnp.asarray(c2w), fx=jnp.asarray(intrin[:, 0]),
                               fy=jnp.asarray(intrin[:, 1]), cx=jnp.asarray(intrin[:, 2]),
                               cy=jnp.asarray(intrin[:, 3]), distortion=jnp.zeros((n_img, 4)),
                               width=W, height=H),
        points=jnp.asarray(pts), point_colors=jnp.asarray(colors),
        point_errors=jnp.zeros(len(pts)), track_counts=jnp.ones(len(pts)),
        registered=jnp.ones(n_img, bool))
    tscene = ttypes.SfMScene(
        cameras=ttypes.Cameras(camtoworlds=c2w, fx=intrin[:, 0], fy=intrin[:, 1],
                               cx=intrin[:, 2], cy=intrin[:, 3],
                               distortion=np.zeros((n_img, 4), np.float32), width=W, height=H),
        points=pts, point_colors=colors, point_errors=np.zeros(len(pts), np.float32),
        track_counts=np.ones(len(pts), np.float32), registered=np.ones(n_img, bool))
    cj, mj = jpipe.train_splat(jscene, images, max_steps=MAX_STEPS, downscale_factor=1,
                               sh_degree=0)
    ct, mt = tpipe.train_splat(tscene, images, max_steps=MAX_STEPS, downscale_factor=1,
                               sh_degree=0, device="cpu")
    assert ct.num_points == cj.num_points == len(pts)
    assert mt["eval_views"] == mj["eval_views"] == 2.0
    for name in ("means", "scales", "quats", "opacities", "sh0"):
        err = float(np.max(np.abs(np.asarray(getattr(cj, name)) - getattr(ct, name))))
        assert err <= TOL_CLOUD, (name, err)
    assert abs(mj["psnr"] - mt["psnr"]) <= 0.01


def test_downscale_images_matches_cv2():
    """Area resampling against cv2.INTER_AREA: an integer factor that divides
    the size (exact box average) and one that does not; 1e-5 abs (f32 sums)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    for h, w in ((48, 64), (50, 67)):
        imgs = rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32)
        got = tpipe.downscale_images(imgs, 2)
        want = np.stack([cv2.resize(im, (w // 2, h // 2), interpolation=cv2.INTER_AREA)
                         for im in imgs])
        assert got.shape == want.shape
        assert float(np.max(np.abs(got - want))) <= 1e-5
        assert np.array_equal(tpipe.downscale_images(imgs, 1), imgs)
    assert tpipe.auto_downscale_factor(300, 4000) == jpipe.auto_downscale_factor(300, 4000)
    assert np.array_equal(tpipe.eval_split(20), jpipe.eval_split(20))


@pytest.mark.parametrize("sh_degree,antialiased", [(0, False), (3, True)])
def test_ply_and_spz_bytes_match_reference(sh_degree, antialiased):
    rng = np.random.default_rng(6)
    n, k = 50, {0: 0, 3: 15}[sh_degree]
    arrays = dict(
        means=rng.normal(0, 3, (n, 3)), scales=rng.normal(-3, 1, (n, 3)),
        quats=rng.normal(0, 1, (n, 4)), opacities=rng.normal(0, 2, n),
        sh0=rng.normal(0, 1, (n, 3)), shN=rng.normal(0, 0.3, (n, k, 3)))
    arrays = {a: v.astype(np.float32) for a, v in arrays.items()}
    jc = jtypes.GaussianCloud(**{a: jnp.asarray(v) for a, v in arrays.items()},
                              antialiased=antialiased)
    tc = ttypes.GaussianCloud(**arrays, antialiased=antialiased)
    written = {}
    for name, jsave, tsave in (("ply", jply.save_ply, tply.save_ply),
                               ("spz", jspz.save_spz, tspz.save_spz)):
        bj, bt = io.BytesIO(), io.BytesIO()
        jsave(jc, bj)
        tsave(tc, bt)
        assert bj.getvalue() == bt.getvalue(), name
        written[name] = bt.getvalue()
    assert np.array_equal(tply.load_ply(io.BytesIO(written["ply"])).means, arrays["means"])
    back = tspz.load_spz(io.BytesIO(written["spz"]))
    assert back.num_points == n and back.antialiased == antialiased


def test_checkpoint_roundtrip(capture, tmp_path):
    """torch.save checkpoint: a resumed trainer continues bit-identically."""
    viewmats, intrin, images, pts, colors = capture
    cfg = ttrainer.TrainConfig(max_steps=4, sh_degree=0, max_per_tile=128, eval_every=10**9)
    cfg = replace(cfg, checkpoint_every=2)

    def make():
        p = tparams.init_params_from_points(pts, colors, capacity=256, sh_degree=0,
                                            device="cpu")
        return ttrainer.Trainer(p, images[:8], viewmats[:8], intrin[:8], scene_scale=2.0,
                                cfg=cfg, device="cpu")

    a = make()
    a.checkpoint_dir = str(tmp_path)
    a.run(2)
    b = make()
    b.load_checkpoint(str(tmp_path))
    assert b.step == 2
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_mcmc_strategy_runs(capture):
    """The per-step loop of the MCMC strategy: relocation at the refine steps,
    exploration noise every step, parameters finite and gaussians alive."""
    viewmats, intrin, images, pts, colors = capture
    cfg = ttrainer.TrainConfig(
        max_steps=4, sh_degree=0, strategy="mcmc", max_per_tile=128, random_background=False,
        eval_every=10**9,
        densify=replace(ttrainer.DensifyConfig(), refine_start=2, refine_stop=4, refine_every=2))
    p = tparams.init_params_from_points(pts, colors, capacity=128, sh_degree=0, device="cpu")
    tr = ttrainer.Trainer(p, images[:4], viewmats[:4], intrin[:4], scene_scale=2.0, cfg=cfg,
                          device="cpu")
    tr.run(4)
    assert tr.step == 4
    assert tparams.num_alive(tr.params) > len(pts)  # relocation grew into dead slots
    for k, v in tr.params.items():
        if v.dtype.is_floating_point:
            assert torch.isfinite(v).all(), k


@pytest.mark.parametrize("model", ["splatfacto", "splatfacto-big", "splatfacto-mcmc",
                                   "splatfacto-w-light", "3dgut", "3dgrt", "nerfacto"])
def test_train_config_schedule_matches_reference(model):
    """for_model, scale_schedule and the effective_cfg K tiers, field by field."""
    from dataclasses import asdict

    jc = jtrainer.TrainConfig.for_model(model, max_steps=30000)
    tc = ttrainer.TrainConfig.for_model(model, max_steps=30000)
    assert asdict(jc) == asdict(tc)
    assert asdict(jtrainer.scale_schedule(jc, 4)) == asdict(ttrainer.scale_schedule(tc, 4))
    for step in (0, 2999, 3000, 3499, 3500, 6100, 15000):
        assert (jtrainer.effective_cfg(jc, step).max_per_tile
                == ttrainer.effective_cfg(tc, step).max_per_tile), step
    with pytest.raises(ValueError):
        ttrainer.TrainConfig.for_model("not-a-model")
