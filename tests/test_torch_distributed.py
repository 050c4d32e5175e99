"""The port's multi-card training (tpu_splat_torch/mesh/{distributed,trainer,
launch}.py, train_splat(distributed=True)) against the JAX package's, on the
CPU: four gloo ranks on the mesh {data: 2, gauss: 2}, one rank per process.

Both packages start from one seeded 64x64 scene (tests/test_distributed.py's
dp_setup shape: 256 capacity, SH degree 0, K=128, no random background). The
reference's outcome on it (make_distributed_train_step on a 2x2 mesh of four
XLA CPU devices, plain and masked, and DistributedTrainer through a refine
and an opacity reset) takes about 40 s to compute, so it is recorded in
torch_distributed_reference.npz by

    JAX_PLATFORMS=cpu python scripts/compare_torch_distributed.py --record

and the slow test test_reference_outcome_matches_record re-runs the
reference and checks the record (`python -m pytest
tests/test_torch_distributed.py -m slow`). The module's four ranks start once
and run every check of the port (mesh_checks in tpu_splat_torch/testing.py);
the launcher test starts two more.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from tpu_splat_torch.gs import params as tparams
from tpu_splat_torch.gs import pipeline as tpipe
from tpu_splat_torch.gs import strategy as tstrategy
from tpu_splat_torch.gs import trainer as ttrainer
from tpu_splat_torch.mesh.launch import spawn_ranks
from tpu_splat_torch.testing import mesh_checks, synthetic_capture

torch.set_num_threads(1)

W = H = 64
MESH = (2, 2)
SCENE_SCALE = 2.0
RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_distributed_reference.npz")
CAPTURE_PIXELS = [(0, 10, 20, 0), (3, 32, 32, 1), (7, 50, 13, 2), (12, 31, 40, 0)]
LOSS_REL = 1e-5  # loss, relative
STATE_REL = 1e-4  # moments, accumulators, camera gradients: max|d| / max|ref|
PARAM_ABS = 1e-6  # parameters, where the reference's |grad| > GRAD_MIN
GRAD_MIN = 1e-6


def configs(trainer_mod, strategy_mod):
    """The step's config and the trainer's (a refine and an opacity reset at
    step 2, a checkpoint every 3 steps, one K tier), in either package."""
    step_cfg = trainer_mod.TrainConfig(max_steps=100, sh_degree=0, max_per_tile=128,
                                       random_background=False)
    trainer_cfg = trainer_mod.TrainConfig(
        max_steps=100, sh_degree=0, max_per_tile=128, warmup_max_per_tile=128,
        post_reset_max_per_tile=128, random_background=False, eval_every=10**9,
        checkpoint_every=3,
        densify=strategy_mod.DensifyConfig(refine_start=2, refine_stop=3, refine_every=2,
                                           grad_threshold=1e-6, reset_opacity_every=2))
    return step_cfg, trainer_cfg


def scene():
    """The 16-view capture, the initial parameters (numpy) and the step's
    batch: views 0-3, half-masked, from zero camera deltas (as the
    reference's tests start). With deltas of 1e-3, one pixel pair of view 1
    sits on the 1/255 alpha cut-off and flips between the packages on a
    last-bit difference of its projection, which moves one gaussian's
    densify accumulator by 1.01e-4 of the tensor's max."""
    viewmats, intrins, images, pts, colors = synthetic_capture(width=W, height=H)
    params = tparams.init_params_from_points(pts, colors, capacity=256, sh_degree=0,
                                             device="cpu")
    masks = np.ones((4, H, W), np.float32)
    masks[:, : H // 2] = 0.0
    batch = dict(images=images[:4], viewmats=viewmats[:4], intrins=intrins[:4], masks=masks,
                 cam_deltas=np.zeros((4, 6), np.float32))
    return viewmats, intrins, images, {k: v.numpy() for k, v in params.items()}, batch


def capture_stats(images):
    return float(images.mean()), [float(images[p]) for p in CAPTURE_PIXELS]


def reference_outcome(inputs) -> dict:
    """The JAX package's outcome on the scene: make_distributed_train_step on
    a 2x2 mesh of four XLA CPU devices (plain and masked) and
    DistributedTrainer through step 2, with the capture's statistics, as the
    record's flat dict of numpy arrays."""
    import jax
    import jax.numpy as jnp

    from tpu_splat.gs import strategy as jstrategy
    from tpu_splat.gs import trainer as jtrainer
    from tpu_splat.gs.optim import adam_init
    from tpu_splat.gs.strategy import densify_state_init
    from tpu_splat.mesh.distributed import make_distributed_train_step, make_mesh, shard_params
    from tpu_splat.mesh.trainer import DistributedTrainer

    viewmats, intrins, images, params, batch = inputs
    step_cfg, trainer_cfg = configs(jtrainer, jstrategy)
    mesh = make_mesh(*MESH, devices=jax.devices()[:4])
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    mean, values = capture_stats(images)
    out = {"capture_mean": np.asarray(mean), "capture_values": np.asarray(values)}
    for name, use_masks in (("plain", False), ("masked", True)):
        sharded = shard_params(jparams, mesh)
        step_fn = make_distributed_train_step(mesh, step_cfg, W, H, 0, SCENE_SCALE,
                                              use_masks=use_masks)
        masks = b["masks"] if use_masks else jnp.zeros((4, 1, 1))
        p, adam, dstate, metrics, cam_grads = step_fn(
            sharded, adam_init(sharded), densify_state_init(256), b["images"], b["viewmats"],
            b["intrins"], masks, b["cam_deltas"], jnp.asarray(0), jax.random.PRNGKey(0))
        out[f"{name} loss"] = np.asarray(metrics["loss"])
        out[f"{name} cam_grads"] = np.asarray(cam_grads)
        for prefix, tree in (("param", p), ("mu", adam.mu), ("nu", adam.nu)):
            out.update({f"{name} {prefix} {k}": np.asarray(v, np.float32 if k != "alive"
                                                           else bool) for k, v in tree.items()})
        out[f"{name} densify grad_accum"] = np.asarray(dstate.grad_accum)
        out[f"{name} densify count_accum"] = np.asarray(dstate.count_accum)
    tr = DistributedTrainer(jparams, images, viewmats, intrins, scene_scale=SCENE_SCALE,
                            cfg=trainer_cfg, mesh=mesh)
    tr.run(2)
    alive = np.asarray(tr.params["alive"])
    out["trainer alive"] = alive
    out["trainer n_alive"] = np.asarray(int(alive.sum()))
    out["trainer opacity max"] = np.asarray(np.asarray(tr.params["opacities"]).max())
    return out


@pytest.fixture(scope="module")
def inputs():
    return scene()


@pytest.fixture(scope="module")
def ranks(inputs):
    """The port's checks, run once on four gloo ranks."""
    viewmats, intrins, images, params, batch = inputs
    step_cfg, trainer_cfg = configs(ttrainer, tstrategy)
    with tempfile.TemporaryDirectory() as ckpt:
        setup = dict(mesh=MESH, params=params,
                     scene_scale=SCENE_SCALE, batch=batch,
                     runs=[("plain", step_cfg, False, 1), ("masked", step_cfg, True, 1)],
                     trainer=dict(cfg=trainer_cfg, images=images, viewmats=viewmats,
                                  intrins=intrins, checkpoint_dir=ckpt))
        return spawn_ranks(mesh_checks, (setup,), "gloo", ["cpu"] * 4, num_threads=1)


@pytest.fixture(scope="module")
def record(inputs):
    images = inputs[2]
    rec = dict(np.load(RECORD))
    mean, values = capture_stats(images)
    # the record was made on this capture
    assert abs(mean - float(rec["capture_mean"])) <= 1e-6
    assert np.abs(np.subtract(values, rec["capture_values"])).max() <= 1e-6
    return rec


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", ["plain", "masked"])
def test_step_matches_reference(ranks, record, name):
    """One step on 4 views, 2 per data row: loss 1e-5 relative; Adam moments
    and densify accumulators within 1e-4 of each tensor's max; parameters
    within 1e-6 wherever the reference's gradient exceeds 1e-6 (a first Adam
    step moves every other value by about its lr, whatever the sign)."""
    run = ranks[0]["runs"][name]
    assert abs(run["loss"][0] - float(record[f"{name} loss"])) <= \
        LOSS_REL * abs(float(record[f"{name} loss"]))
    state = run["state"]
    checked = held = 0
    for key, got in state.items():
        want = record[f"{name} {key}"]
        assert got.shape == want.shape, key
        if key.startswith(("mu ", "nu ", "densify ")):
            # the round gaussians' quaternion gradient is 0 in exact arithmetic:
            # the reference's rounding leaves it exactly 0 and the port's at
            # about 1e-11, so an all-zero reference tensor is held against the
            # largest tensor of its kind instead
            kind = key.split()[0]
            scale = max(np.abs(record[k]).max(initial=0.0) for k in record
                        if k.startswith(f"{name} {kind} "))
            denom = np.abs(want).max(initial=0.0) or scale
            err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0) / denom)
            assert err <= STATE_REL, (key, err)
            checked += 1
        elif key.startswith("param ") and key != "param alive":
            # after a first step mu = 0.1 * grad
            grad = 10.0 * record[f"{name} mu {key[len('param '):]}"]
            big = np.abs(grad) > GRAD_MIN
            if big.any():
                assert np.abs(got - want)[big].max() <= PARAM_ABS, key
            held += int(big.sum())
            checked += 1
    assert np.array_equal(state["param alive"], record[f"{name} param alive"])
    assert checked == 6 + 2 * 6 + 2 and held > 400
    if name == "masked":
        assert abs(run["loss"][0] - ranks[0]["runs"]["plain"]["loss"][0]) > 1e-6


@pytest.mark.parametrize("name", ["plain", "masked"])
def test_camera_gradients_match_reference(ranks, record, name):
    got = ranks[0]["runs"][name]["cam_grads"][0]
    want = record[f"{name} cam_grads"]
    assert got.shape == want.shape == (4, 6)
    assert np.abs(want).max() > 0
    assert rel(got, want) <= STATE_REL, rel(got, want)


def test_ranks_hold_their_shard_and_agree(ranks):
    """Each rank holds 256 / 2 rows of every parameter; every rank gathers the
    same full state, bit for bit, and the same camera gradients."""
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert set(r["shard_rows"].values()) == {128}
        for name in ("plain", "masked"):
            a, b = ranks[0]["runs"][name], r["runs"][name]
            assert a["loss"] == b["loss"]
            assert np.array_equal(a["cam_grads"][0], b["cam_grads"][0])
            for key in a["state"]:
                assert np.array_equal(a["state"][key], b["state"][key]), (r["rank"], key)
        for when, state in ranks[0]["trainer"].items():
            for key in state:
                assert np.array_equal(state[key], r["trainer"][when][key]), (when, key)


def test_trainer_refine_and_reset_match_reference(ranks, record):
    """DistributedTrainer through step 2 (a refine, then an opacity reset):
    the same gaussians survive and are added as in the reference (the split
    offsets are random draws in both, so only counts and masks compare), and
    every opacity is clamped with its Adam moments cleared."""
    got = ranks[0]["trainer"]["step 2"]
    alive = got["param alive"]
    assert np.array_equal(alive, record["trainer alive"])
    assert int(alive.sum()) == int(record["trainer n_alive"]) > 60
    logit = float(np.log(np.float32(0.01 / 0.99)))
    assert got["param opacities"].max() <= logit + 1e-6
    assert float(record["trainer opacity max"]) <= logit + 1e-6
    assert not got["mu opacities"].any() and not got["nu opacities"].any()
    assert int(got["step"]) == 2


def test_checkpoint_restores_and_runs_on(ranks):
    """A checkpoint saved at step 3 restores bit for bit into a fresh trainer,
    whose next step equals the first trainer's, bit for bit."""
    states = ranks[0]["trainer"]
    assert int(states["step 3"]["step"]) == 3 and int(states["resumed"]["step"]) == 4
    for key in states["step 3"]:
        assert np.array_equal(states["step 3"][key], states["restored"][key]), key
        assert np.array_equal(states["step 4"][key], states["resumed"][key]), key
    assert np.abs(states["step 4"]["param means"] - states["step 3"]["param means"]).max() > 0
    assert np.abs(states["step 4"]["cam_deltas"]).max() > 0


def test_kernels_are_not_launched_on_the_cpu(ranks):
    """On the CPU every rank renders and steps Adam through the kernels' plain
    versions."""
    for r in ranks:
        assert r["launches"] == {"composite_fwd": 0, "composite_bwd": 0, "adam": 0}


def test_train_splat_distributed_on_two_cpu_ranks(tmp_path):
    """train_splat(distributed=True, device="cpu") on 2 gloo ranks returns a
    cloud and a finite PSNR, as tests/test_runner_wiring.py asks of the
    reference; rank 0's log (the checkpoints of the scaled schedule among
    it) reaches the caller. 8 steps of 2 views scale to 4 steps."""
    from tpu_splat_torch.core.types import Cameras, SfMScene

    viewmats, intrins, images, _, _ = synthetic_capture(width=32, height=32, focal=30.0)
    n = len(viewmats)
    rng = np.random.default_rng(0)
    cams = Cameras(camtoworlds=np.linalg.inv(viewmats).astype(np.float32), fx=intrins[:, 0],
                   fy=intrins[:, 1], cx=intrins[:, 2], cy=intrins[:, 3],
                   distortion=np.zeros((n, 4), np.float32), width=32, height=32)
    pts = rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)
    scene_ = SfMScene(cameras=cams, points=pts,
                      point_colors=rng.uniform(0, 1, (300, 3)).astype(np.float32),
                      point_errors=np.zeros(300, np.float32),
                      track_counts=np.full(300, 3, np.float32), registered=np.ones(n, bool))
    lines = []
    cloud, metrics = tpipe.train_splat(scene_, images, max_steps=8, sh_degree=0,
                                       distributed=True, world_size=2, device="cpu",
                                       checkpoint_dir=str(tmp_path / "ckpt"),
                                       checkpoint_every=8, log_fn=lines.append)
    assert cloud.num_points > 100
    assert np.isfinite(metrics["psnr"]) and metrics["train_steps"] == 8.0
    assert any("2 gloo ranks" in s for s in lines)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["meta_00000004.json", "step_00000004.pt"]
    assert any(s.endswith("step_00000004.pt") for s in lines), lines
    with pytest.raises(ValueError, match="world_size"):
        tpipe.train_splat(scene_, images, max_steps=2, distributed=True, device="cpu")


def test_profile_hook_writes_a_trace(tmp_path, monkeypatch):
    """TPU_SPLAT_PROFILE=<dir> makes Trainer.run stepwise and writes a
    torch.profiler trace of steps 20-40 into <dir>; a run of 21 steps, the
    fewest that reach the window, ends inside it and still writes the trace."""
    viewmats, intrins, images, pts, colors = synthetic_capture(n=20, width=32, height=32,
                                                               focal=30.0, n_views=4)
    params = tparams.init_params_from_points(pts, colors, capacity=64, sh_degree=0,
                                             device="cpu")
    cfg = ttrainer.TrainConfig(max_steps=21, sh_degree=0, max_per_tile=128,
                               warmup_max_per_tile=128, random_background=False)
    lines = []
    monkeypatch.setenv(ttrainer.PROFILE_ENV, str(tmp_path))
    tr = ttrainer.Trainer(params, images, viewmats, intrins, 1.0, cfg, log_fn=lines.append,
                          device="cpu")
    tr.run(21)
    assert tr.step == 21
    traces = [n for n in os.listdir(tmp_path) if n.endswith(".pt.trace.json")]
    assert len(traces) == 1 and os.path.getsize(tmp_path / traces[0]) > 0
    assert any("steps 20-40" in s for s in lines)


@pytest.mark.slow
def test_reference_outcome_matches_record(inputs, request):
    """The reference's distributed step and trainer reproduce the record
    (losses and tensors within 1e-6 of each tensor's max, masks exactly). It
    runs only when selected by its marker (-m slow)."""
    if "slow" not in request.config.getoption("markexpr"):
        pytest.skip("re-runs the reference's distributed step and trainer (about 40 s): "
                    "select it with -m slow")
    rec = dict(np.load(RECORD))
    fresh = reference_outcome(inputs)
    assert set(fresh) == set(rec)
    for key, want in rec.items():
        if want.dtype == bool or key in ("trainer n_alive",):
            assert np.array_equal(fresh[key], want), key
        else:
            assert rel(fresh[key], want) <= 1e-6, key
