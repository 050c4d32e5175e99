"""3DGS training loop (the port of tpu_splat/gs/trainer.py).

One train step renders a view, takes the loss, backpropagates through the
rasterizer's CUDA kernels and applies selective Adam over fixed-capacity
parameter tensors; densification runs between steps on the same slots. The
reference chains steps inside one jitted `lax.scan` between host events; here
the chunk between two events is a plain Python loop with the same event
boundaries, view schedule and per-step semantics.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.gs import mcmc as mcmc_mod
from tpu_splat_torch.gs.losses import image_loss, opacity_entropy_loss, psnr, scale_regularization
from tpu_splat_torch.gs.optim import AdamState, adam_init, adam_update
from tpu_splat_torch.gs.params import Params, grow_capacity, grow_tree, num_alive, params_to_cloud
from tpu_splat_torch.gs.projection import project_gaussians
from tpu_splat_torch.gs.render import render_view
from tpu_splat_torch.gs.strategy import (
    DensifyConfig,
    DensifyState,
    accumulate_gradients,
    densify_state_init,
    refine,
    reset_opacity,
)
from tpu_splat_torch.sfm.geometry import exp_so3

CAM_B1, CAM_B2, CAM_EPS = 0.9, 0.999, 1e-8
PROFILE_ENV = "TPU_SPLAT_PROFILE"  # =<dir>: trace steps 20-40 into <dir>


@dataclass(frozen=True)
class TrainConfig:
    max_steps: int = 30000
    sh_degree: int = 3
    sh_degree_interval: int = 1000  # raise active SH degree every N steps
    ssim_lambda: float = 0.2
    # learning rates (gsplat/splatfacto defaults)
    lr_means: float = 1.6e-4  # x scene_scale, exponentially decayed
    lr_means_final: float = 1.6e-6
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacities: float = 5e-2
    lr_sh0: float = 2.5e-3
    lr_shN: float = 2.5e-3 / 20.0
    densify: DensifyConfig = field(default_factory=DensifyConfig)
    strategy: str = "default"  # default | mcmc
    mcmc: mcmc_mod.MCMCConfig = field(default_factory=mcmc_mod.MCMCConfig)
    # Per-tile rasterizer capacity K, and the higher tiers effective_cfg
    # switches to right after an opacity reset and before the first one.
    max_per_tile: int = 256
    post_reset_max_per_tile: int = 512
    post_reset_recover_steps: int = 500
    warmup_max_per_tile: int = 0  # 0 = auto (4x max_per_tile, capped at 1024)
    tile_size: int = 16
    random_background: bool = True
    scale_reg_weight: float = 0.0
    opacity_reg_weight: float = 0.0
    selective_adam: bool = False
    antialiased: bool = False
    grow_threshold: float = 0.95
    eval_every: int = 1000
    # per-view se(3) pose deltas trained jointly with the splat
    optimize_camera_poses: bool = True
    lr_camera: float = 1e-4
    checkpoint_every: int = 2000

    @classmethod
    def for_model(cls, model: str, max_steps: int = 30000) -> "TrainConfig":
        """Map the job-JSON model names to configs."""
        base = cls(max_steps=max_steps)
        if model == "splatfacto":
            return base
        if model == "splatfacto-big":
            return replace(base, densify=replace(base.densify, grad_threshold=0.0001))
        if model == "splatfacto-mcmc":
            return replace(base, strategy="mcmc")
        if model == "splatfacto-w-light":
            return replace(base, opacity_reg_weight=0.01, random_background=True)
        if model in ("3dgut", "3dgrt"):
            # ray-tracing models map onto the rasterizer with antialiasing and
            # selective Adam
            return replace(base, antialiased=True, selective_adam=True)
        if model == "nerfacto":
            return base
        raise ValueError(f"unknown model {model!r}")


def scale_schedule(cfg: TrainConfig, factor: int) -> TrainConfig:
    """gsplat --steps_scaler semantics: when each step consumes `factor` views,
    shrink the step count and every step-indexed milestone by that factor."""
    if factor <= 1:
        return cfg

    def f(v: int) -> int:
        return max(int(v // factor), 1)

    return replace(
        cfg,
        max_steps=f(cfg.max_steps),
        sh_degree_interval=f(cfg.sh_degree_interval),
        eval_every=f(cfg.eval_every),
        checkpoint_every=f(cfg.checkpoint_every),
        post_reset_recover_steps=f(cfg.post_reset_recover_steps),
        densify=replace(
            cfg.densify,
            refine_start=f(cfg.densify.refine_start),
            refine_stop=f(cfg.densify.refine_stop),
            refine_every=f(cfg.densify.refine_every),
            reset_opacity_every=f(cfg.densify.reset_opacity_every),
        ),
    )


def effective_cfg(cfg: TrainConfig, step: int) -> TrainConfig:
    """The config to run `step` with: warmup_max_per_tile before the first
    opacity reset (a sparse seed cloud with huge knn scales overflows every
    tile, and dropped gaussians get no screen gradient), and
    post_reset_max_per_tile within post_reset_recover_steps of a reset."""
    d = cfg.densify
    warmup_k = cfg.warmup_max_per_tile or min(4 * cfg.max_per_tile, 1024)
    if d.reset_opacity_every > 0 and warmup_k > cfg.max_per_tile \
            and step < min(d.reset_opacity_every, d.refine_stop):
        return replace(cfg, max_per_tile=warmup_k)
    if cfg.post_reset_max_per_tile <= cfg.max_per_tile or d.reset_opacity_every <= 0:
        return cfg
    last_reset = (step // d.reset_opacity_every) * d.reset_opacity_every
    if (d.refine_start <= last_reset < d.refine_stop and last_reset > 0
            and step - last_reset < cfg.post_reset_recover_steps):
        return replace(cfg, max_per_tile=cfg.post_reset_max_per_tile)
    return cfg


def _lr_tree(cfg: TrainConfig, scene_scale: float, step: int, max_steps: int) -> Dict[str, float]:
    # the means schedule in f32, as the reference computes it
    t = np.clip(np.float32(step) / np.float32(max_steps), np.float32(0.0), np.float32(1.0))
    decay = np.float32(cfg.lr_means_final / cfg.lr_means) ** t
    return {
        "means": float(np.float32(cfg.lr_means * scene_scale) * decay),
        "scales": cfg.lr_scales,
        "quats": cfg.lr_quats,
        "opacities": cfg.lr_opacities,
        "sh0": cfg.lr_sh0,
        "shN": cfg.lr_shN,
    }


def apply_camera_delta(viewmat: torch.Tensor, cam_delta: torch.Tensor) -> torch.Tensor:
    """Left-apply an se(3) delta (w, dt) to a 4x4 w2c matrix."""
    R = exp_so3(cam_delta[:3]) @ viewmat[:3, :3]
    t = viewmat[:3, 3] + cam_delta[3:]
    top = torch.cat([R, t[:, None]], dim=1)
    return torch.cat([top, viewmat[3:4].detach()], dim=0)


def train_step(
    params: Params,
    adam_state: AdamState,
    dstate: DensifyState,
    image: torch.Tensor,
    viewmat: torch.Tensor,
    intrin,
    step: int,
    generator: torch.Generator,
    scene_scale: float,
    cfg: TrainConfig,
    width: int,
    height: int,
    active_sh_degree: int,
    cam_delta: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
):
    """One optimization step on one view. intrin = (fx, fy, cx, cy) floats.
    Returns (params, adam, dstate, metrics[, cam_grad]); metrics hold 0-d
    tensors, so the step does not wait for the device."""
    alive = params["alive"]
    dev = alive.device
    capacity = alive.shape[0]
    fx, fy, cx, cy = (float(v) for v in intrin)
    trainable = {k: v.detach().requires_grad_(True) for k, v in params.items() if k != "alive"}
    opt_cams = cam_delta is not None
    cd = (cam_delta if opt_cams else torch.zeros(6, device=dev)).detach()
    cd.requires_grad_(opt_cams)

    if cfg.random_background:
        bg = torch.rand(3, generator=generator, device=dev)
    else:
        bg = torch.zeros(3, device=dev)

    dummy = torch.zeros((capacity, 2), device=dev, requires_grad=True)
    p = trainable
    out = render_view(
        p["means"], p["scales"], p["quats"], p["opacities"], p["sh0"], p["shN"],
        apply_camera_delta(viewmat, cd), fx, fy, cx, cy, width, height,
        sh_degree=active_sh_degree, background=bg, antialiased=cfg.antialiased,
        tile_size=cfg.tile_size, max_per_tile=cfg.max_per_tile,
        means2d_dummy=dummy, alive=alive, device=dev,
    )
    gt = image
    alpha_loss = 0.0
    if mask is not None:
        # masked captures: composite the subject over the training background
        # and pull rendered alpha toward the mask
        m = mask[..., None]
        gt = gt * m + bg * (1.0 - m)
        alpha_loss = torch.mean(torch.abs(out.alpha - mask))
    loss = image_loss(out.color, gt, cfg.ssim_lambda) + 0.1 * alpha_loss
    if cfg.scale_reg_weight > 0:
        loss = loss + cfg.scale_reg_weight * scale_regularization(p["scales"], alive)
    if cfg.opacity_reg_weight > 0:
        loss = loss + cfg.opacity_reg_weight * opacity_entropy_loss(p["opacities"], alive)

    names = list(trainable)
    inputs = [trainable[k] for k in names] + [dummy] + ([cd] if opt_cams else [])
    # a degree-0 cloud has an empty shN that the render never reads
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, torch.autograd.grad(loss, inputs, allow_unused=True))]

    with torch.no_grad():
        means2d_grad = grads[len(names)]
        # radii for visibility, from the undelta'd pose as in the reference
        proj = project_gaussians(trainable["means"], trainable["scales"], trainable["quats"],
                                 viewmat, fx, fy, cx, cy, width, height)
        radii = torch.where(alive, proj.radii, torch.zeros_like(proj.radii))
        lrs = _lr_tree(cfg, scene_scale, step, cfg.max_steps)
        visible = (radii > 0) if cfg.selective_adam else None
        new_trainable, adam_state = adam_update(
            {k: v.detach() for k, v in trainable.items()}, dict(zip(names, grads)), adam_state,
            lrs, visible=visible, grad_mask=alive)
        new_params = dict(new_trainable)
        new_params["alive"] = alive
        dstate = accumulate_gradients(dstate, means2d_grad, radii, width, height)
        metrics = {"loss": loss.detach(), "psnr": psnr(out.color.detach(), image)}
    if opt_cams:
        return new_params, adam_state, dstate, metrics, grads[-1]
    return new_params, adam_state, dstate, metrics


def checkpoint_path(directory: str, step: Optional[int] = None):
    """(path, step) of the given-step checkpoint under `directory`, or of the
    latest one; raises FileNotFoundError when there is none."""
    root = os.path.abspath(directory)
    if step is None:
        steps = sorted(int(n[len("step_"):-len(".pt")]) for n in os.listdir(root)
                       if n.startswith("step_") and n.endswith(".pt"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {root}")
        step = steps[-1]
    return os.path.join(root, f"step_{step:08d}.pt"), step


class Trainer:
    """Host-side training driver: camera sampling, refine scheduling, growth."""

    def __init__(
        self,
        params: Params,
        images: np.ndarray,  # (M, H, W, 3) float32 in [0, 1]
        viewmats: np.ndarray,  # (M, 4, 4) world-to-camera
        intrinsics: np.ndarray,  # (M, 4) fx fy cx cy
        scene_scale: float,
        cfg: TrainConfig,
        seed: int = 0,
        masks: Optional[np.ndarray] = None,  # (M, H, W) subject masks
        log_fn: Optional[Callable[[str], None]] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.images = images
        self.masks = masks
        self.viewmats = torch.as_tensor(np.asarray(viewmats), dtype=torch.float32,
                                        device=self.device)
        self.intrinsics = np.asarray(intrinsics, np.float32)
        self.scene_scale = float(scene_scale)
        self.cfg = cfg
        self.adam = adam_init(self.params)
        self.dstate = densify_state_init(self.params["means"].shape[0], self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.step = 0
        self.log = log_fn or (lambda s: None)
        self.height, self.width = images.shape[1:3]
        n_views = images.shape[0]
        self.cam_deltas = torch.zeros((n_views, 6), device=self.device)
        self._cam_mu = torch.zeros((n_views, 6), device=self.device)
        self._cam_nu = torch.zeros((n_views, 6), device=self.device)
        self.checkpoint_dir: Optional[str] = None
        # training images staged on the device once (built lazily in run)
        self._images_dev: Optional[torch.Tensor] = None
        self._masks_dev: Optional[torch.Tensor] = None

    def _active_sh_degree(self) -> int:
        return min(self.step // self.cfg.sh_degree_interval, self.cfg.sh_degree)

    def _next_event_boundary(self, end: int) -> int:
        """First step > self.step where the host must intervene: refine pass,
        opacity reset, post-reset K-window edge, SH-degree bump, eval log or
        checkpoint. The per-chunk config is constant inside a chunk."""
        cfg = self.cfg
        d = cfg.densify
        s = self.step
        periods = [cfg.eval_every, cfg.sh_degree_interval]
        if cfg.strategy == "default":
            periods += [d.refine_every, d.reset_opacity_every]
        if self.checkpoint_dir:
            periods.append(cfg.checkpoint_every)
        nxt = min((s // p + 1) * p for p in periods if p > 0)
        if cfg.strategy == "default" and d.reset_opacity_every > 0:
            last_reset = (s // d.reset_opacity_every) * d.reset_opacity_every
            recover_end = last_reset + cfg.post_reset_recover_steps
            if s < recover_end:
                nxt = min(nxt, recover_end)
        return min(nxt, end)

    def _stage(self):
        if self._images_dev is None:
            self._images_dev = torch.as_tensor(self.images, dtype=torch.float32,
                                               device=self.device)
            if self.masks is not None:
                self._masks_dev = torch.as_tensor(self.masks.astype(np.float32),
                                                  device=self.device)

    def _train_one(self, view: int, step_cfg: TrainConfig, sh_degree: int):
        """One step on `view` at self.step (camera Adam included)."""
        mask = self._masks_dev[view] if self._masks_dev is not None else None
        args = (self.params, self.adam, self.dstate, self._images_dev[view],
                self.viewmats[view], self.intrinsics[view], self.step, self.generator,
                self.scene_scale, step_cfg, self.width, self.height, sh_degree)
        if self.cfg.optimize_camera_poses:
            (self.params, self.adam, self.dstate, metrics, cam_grad) = train_step(
                *args, cam_delta=self.cam_deltas[view], mask=mask)
            self._update_camera(view, cam_grad)
        else:
            self.params, self.adam, self.dstate, metrics = train_step(*args, mask=mask)
        return metrics

    def run(self, steps: Optional[int] = None) -> Params:
        cfg = self.cfg
        total = steps if steps is not None else cfg.max_steps
        # the stepwise loop serves the profiling hook and MCMC, whose
        # exploration noise is a host event on every step
        if os.environ.get(PROFILE_ENV, "") or cfg.strategy == "mcmc":
            return self._run_stepwise(total)
        n_views = self.images.shape[0]
        rng = np.random.default_rng(42)
        t0 = time.time()
        self._stage()
        start_step = self.step
        end = self.step + total
        while self.step < end:
            boundary = self._next_event_boundary(end)
            views = rng.integers(n_views, size=boundary - self.step)
            step_cfg = effective_cfg(cfg, self.step)
            sh_degree = self._active_sh_degree()
            for view in views:
                metrics = self._train_one(int(view), step_cfg, sh_degree)
                self.step += 1
            if self.checkpoint_dir and self.step % cfg.checkpoint_every == 0:
                self.save_checkpoint(self.checkpoint_dir)
            if cfg.strategy == "default":
                self._default_refine()
            if self.step % cfg.eval_every == 0 or self.step == end:
                rate = (self.step - start_step) / max(time.time() - t0, 1e-9)
                self.log(
                    f"step {self.step}: loss={float(metrics['loss']):.4f} "
                    f"psnr={float(metrics['psnr']):.2f} alive={num_alive(self.params)} "
                    f"({rate:.1f} it/s)"
                )
        return self.params

    def _run_stepwise(self, total: int) -> Params:
        """Per-step loop. With TPU_SPLAT_PROFILE=<dir> it writes a
        torch.profiler trace of steps 20-40 into <dir> (TensorBoard's format;
        the reference writes an xprof trace of the same steps)."""
        cfg = self.cfg
        n_views = self.images.shape[0]
        rng = np.random.default_rng(42)
        t0 = time.time()
        self._stage()
        profile_dir = os.environ.get(PROFILE_ENV, "")
        prof = None
        for _ in range(total):
            if profile_dir and self.step == 20 and prof is None:
                prof = self._start_profile(profile_dir)
            elif prof is not None and self.step >= 40:
                self._stop_profile(prof, profile_dir)
                prof = None
            view = int(rng.integers(n_views))
            metrics = self._train_one(view, effective_cfg(cfg, self.step),
                                      self._active_sh_degree())
            self.step += 1
            if self.checkpoint_dir and self.step % cfg.checkpoint_every == 0:
                self.save_checkpoint(self.checkpoint_dir)
            if cfg.strategy == "default":
                self._default_refine()
            else:
                self._mcmc_refine()
            if self.step % cfg.eval_every == 0 or self.step == total:
                self.log(
                    f"step {self.step}: loss={float(metrics['loss']):.4f} "
                    f"psnr={float(metrics['psnr']):.2f} alive={num_alive(self.params)} "
                    f"({self.step / (time.time() - t0):.1f} it/s)"
                )
        if prof is not None:  # the run ended inside the trace window
            self._stop_profile(prof, profile_dir)
        return self.params

    def _start_profile(self, directory: str):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(directory))
        prof.start()
        return prof

    def _stop_profile(self, prof, directory: str):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        self.log(f"profiler trace (steps 20-40) written to {directory}")

    def _default_refine(self):
        cfg = self.cfg
        d = cfg.densify
        if d.refine_start <= self.step < d.refine_stop and self.step % d.refine_every == 0:
            self.params, self.adam, self.dstate, stats = refine(
                self.params, self.adam, self.dstate, self.generator, self.scene_scale, d,
                self.step,
            )
            if self.step % cfg.eval_every == 0:
                self.log(
                    f"refine @{self.step}: split={int(stats['n_split'])} "
                    f"dup={int(stats['n_dup'])} pruned={int(stats['n_pruned'])} "
                    f"alive={int(stats['n_alive'])}")
            capacity = self.params["means"].shape[0]
            if num_alive(self.params) > cfg.grow_threshold * capacity:
                self._grow(capacity * 2)
        if self.step % d.reset_opacity_every == 0 and d.refine_start <= self.step < d.refine_stop:
            self.params, self.adam = reset_opacity(self.params, self.adam,
                                                   d.reset_opacity_value)

    def _grow(self, new_cap: int):
        self.log(f"growing capacity {self.params['means'].shape[0]} -> {new_cap}")
        self.params = grow_capacity(self.params, new_cap)
        self.adam = AdamState(mu=grow_tree(self.adam.mu, new_cap),
                              nu=grow_tree(self.adam.nu, new_cap), count=self.adam.count)
        self.dstate = densify_state_init(new_cap, self.device)

    def _mcmc_refine(self):
        cfg = self.cfg
        d = cfg.densify
        if d.refine_start <= self.step < d.refine_stop and self.step % d.refine_every == 0:
            self.params, self.adam = mcmc_mod.relocate_and_grow(
                self.params, self.adam, self.generator, cfg.mcmc)
        lr_means = float(cfg.lr_means * self.scene_scale)
        self.params = mcmc_mod.add_noise(self.params, self.generator, lr_means, cfg.mcmc)

    @torch.no_grad()
    def _update_camera(self, view: int, grad: torch.Tensor):
        """Adam update for one camera's se(3) delta (t = max(step, 1))."""
        mu = CAM_B1 * self._cam_mu[view] + (1 - CAM_B1) * grad
        nu = CAM_B2 * self._cam_nu[view] + (1 - CAM_B2) * grad * grad
        t = max(self.step, 1)
        step_v = (self.cfg.lr_camera * (mu / (1 - CAM_B1**t))
                  / (torch.sqrt(nu / (1 - CAM_B2**t)) + CAM_EPS))
        self._cam_mu[view] = mu
        self._cam_nu[view] = nu
        self.cam_deltas[view] -= step_v

    @torch.no_grad()
    def adjusted_viewmats(self) -> np.ndarray:
        """World-to-camera matrices with the learned pose corrections applied."""
        return np.stack([
            apply_camera_delta(self.viewmats[i], self.cam_deltas[i]).cpu().numpy()
            for i in range(self.viewmats.shape[0])
        ])

    # ---------- checkpointing (torch.save) ----------

    def _ckpt_state(self) -> dict:
        def host(tree):
            return {k: v.detach().cpu() for k, v in tree.items()}

        return {
            "params": host(self.params),
            "adam_mu": host(self.adam.mu),
            "adam_nu": host(self.adam.nu),
            "adam_count": self.adam.count.cpu(),
            "dstate_grad": self.dstate.grad_accum.cpu(),
            "dstate_count": self.dstate.count_accum.cpu(),
            "cam_deltas": self.cam_deltas.cpu(),
            "cam_mu": self._cam_mu.cpu(),
            "cam_nu": self._cam_nu.cpu(),
            "step": self.step,
            "generator": self.generator.get_state(),
        }

    def save_checkpoint(self, directory: str):
        """Write a resumable checkpoint at the current step, with a sidecar
        holding the saved capacity (densification grows it mid-run)."""
        root = os.path.abspath(directory)
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, f"step_{self.step:08d}.pt")
        tmp = path + ".tmp"
        torch.save(self._ckpt_state(), tmp)
        os.replace(tmp, path)
        with open(os.path.join(root, f"meta_{self.step:08d}.json"), "w") as f:
            json.dump({
                "capacity": int(self.params["means"].shape[0]),
                "n_views": int(self.cam_deltas.shape[0]),
                "step": self.step,
            }, f)
        self.log(f"checkpoint saved: {path}")

    def load_checkpoint(self, directory: str, step: Optional[int] = None):
        """Restore the latest (or given-step) checkpoint and resume from it.
        A checkpoint saved after capacity growth grows the live state first; a
        larger live capacity than the checkpoint's is rejected."""
        path, step = checkpoint_path(directory, step)
        meta_path = os.path.join(os.path.dirname(path), f"meta_{step:08d}.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if int(meta["n_views"]) != int(self.cam_deltas.shape[0]):
                raise ValueError(
                    f"checkpoint has {meta['n_views']} views, trainer has "
                    f"{self.cam_deltas.shape[0]}; input set changed, cannot resume")
            saved_cap = int(meta["capacity"])
            cap = self.params["means"].shape[0]
            if saved_cap > cap:
                self._grow(saved_cap)
            elif saved_cap < cap:
                raise ValueError(
                    f"checkpoint capacity {saved_cap} < trainer capacity {cap}; "
                    f"initialization changed, cannot resume")
        state = torch.load(path, map_location="cpu", weights_only=True)
        dev = self.device

        def put(tree):
            return {k: v.to(dev) for k, v in tree.items()}

        self.params = put(state["params"])
        self.adam = AdamState(mu=put(state["adam_mu"]), nu=put(state["adam_nu"]),
                              count=state["adam_count"].to(dev))
        self.dstate = DensifyState(grad_accum=state["dstate_grad"].to(dev),
                                   count_accum=state["dstate_count"].to(dev))
        self.cam_deltas = state["cam_deltas"].to(dev)
        self._cam_mu = state["cam_mu"].to(dev)
        self._cam_nu = state["cam_nu"].to(dev)
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
        self.log(f"checkpoint restored: {path}")

    def cloud(self):
        return params_to_cloud(self.params)
