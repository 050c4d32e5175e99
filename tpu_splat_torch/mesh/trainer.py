"""Multi-card training loop (the port of tpu_splat/mesh/trainer.py).

Wraps the sharded step of distributed.py in the reference's host loop: one
view per data row each step, the step config by effective_cfg and the SH
ramp, masked-capture losses, per-view camera-pose Adam, periodic refine and
opacity resets, and checkpoints. Every rank of the process group runs the
same loop. A refine gathers the full state, runs strategy.refine on every rank
from one identically seeded generator (so the ranks agree on the result), and
keeps each rank's shard; an opacity reset is elementwise and runs on the
shards.

`train_distributed` is train_splat's launcher: one process drives the job and
spawns one rank per card (mesh/launch.py); rank 0 hands the trained state back.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_splat_torch.gs.optim import AdamState, adam_init
from tpu_splat_torch.gs.params import Params, params_to_cloud
from tpu_splat_torch.gs.strategy import DensifyState, densify_state_init, refine, reset_opacity
from tpu_splat_torch.gs.trainer import (CAM_B1, CAM_B2, CAM_EPS, TrainConfig, apply_camera_delta,
                                        checkpoint_path, effective_cfg, scale_schedule)
from tpu_splat_torch.mesh.distributed import make_distributed_train_step, make_mesh, shard_params


class DistributedTrainer:
    """Data-parallel (x gaussian-sharded) training over a mesh of ranks.

    Works in any initialised process group (spawned by train_distributed, or
    started by torchrun); every rank constructs it with the same arguments.
    `device` is the rank's (its current card unless the caller names one)."""

    def __init__(
        self,
        params: Params,
        images: np.ndarray,
        viewmats: np.ndarray,
        intrinsics: np.ndarray,
        scene_scale: float,
        cfg: TrainConfig,
        mesh=None,
        n_gauss: int = 1,
        seed: int = 0,
        masks: Optional[np.ndarray] = None,  # (M, H, W) subject masks
        log_fn: Optional[Callable[[str], None]] = None,
        device=None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh(n_gauss=n_gauss, device=device)
        self.device = self.mesh.device
        self.batch = self.mesh.shape["data"]
        self.cfg = cfg
        self.images = images
        self.masks = masks
        self.viewmats = torch.as_tensor(np.asarray(viewmats), dtype=torch.float32,
                                        device=self.device)
        self.intrinsics = np.asarray(intrinsics, np.float32)
        self.scene_scale = float(scene_scale)
        self.height, self.width = images.shape[1:3]
        self.log = log_fn or (lambda s: None)
        # step keys (the random background) come from a host generator; refine
        # draws from a device generator; both seeded alike on every rank
        self.keys = torch.Generator()
        self.keys.manual_seed(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.step = 0

        self.params = shard_params(params, self.mesh)
        self.adam = adam_init(self.params)
        self.dstate = densify_state_init(self.params["means"].shape[0], self.device)
        self._step_fn = {}
        self.checkpoint_dir: Optional[str] = None
        n_views = images.shape[0]
        self.cam_deltas = torch.zeros((n_views, 6), device=self.device)
        self._cam_mu = torch.zeros((n_views, 6), device=self.device)
        self._cam_nu = torch.zeros((n_views, 6), device=self.device)
        self._images_dev: Optional[torch.Tensor] = None
        self._masks_dev: Optional[torch.Tensor] = None

    def _get_step_fn(self):
        deg = min(self.step // self.cfg.sh_degree_interval, self.cfg.sh_degree)
        cfg = effective_cfg(self.cfg, self.step)  # post-reset capacity boost
        key = (deg, cfg.max_per_tile)
        if key not in self._step_fn:
            self._step_fn[key] = make_distributed_train_step(
                self.mesh, cfg, self.width, self.height, deg, self.scene_scale,
                use_masks=self.masks is not None)
        return self._step_fn[key]

    def _stage(self):
        if self._images_dev is None:
            self._images_dev = torch.as_tensor(self.images, dtype=torch.float32,
                                               device=self.device)
            if self.masks is not None:
                self._masks_dev = torch.as_tensor(self.masks.astype(np.float32),
                                                  device=self.device)

    def run(self, steps: int):
        cfg = self.cfg
        rng = np.random.default_rng(17)
        n_views = self.images.shape[0]
        t0 = time.time()
        self._stage()
        for _ in range(steps):
            views = rng.choice(n_views, size=self.batch, replace=n_views < self.batch)
            idx = torch.as_tensor(views, device=self.device)
            batch_masks = (self._masks_dev[idx] if self._masks_dev is not None
                           else torch.zeros((self.batch, 1, 1), device=self.device))
            key = int(torch.randint(0, 2**62, (1,), generator=self.keys))
            (self.params, self.adam, self.dstate, metrics, cam_grads) = self._get_step_fn()(
                self.params, self.adam, self.dstate, self._images_dev[idx],
                self.viewmats[idx], self.intrinsics[views], batch_masks,
                self.cam_deltas[idx], self.step, key)
            if cfg.optimize_camera_poses:
                self._update_cameras(views, cam_grads)
            self.step += 1
            self._maybe_refine()
            if self.checkpoint_dir and self.step % cfg.checkpoint_every == 0:
                self.save_checkpoint(self.checkpoint_dir)
            if self.step % cfg.eval_every == 0:
                self.log(
                    f"step {self.step}: loss={float(metrics['loss']):.4f} "
                    f"alive={self.num_alive()} "
                    f"({self.step / (time.time() - t0):.1f} it/s x{self.batch} views)")

    @torch.no_grad()
    def _update_cameras(self, views: np.ndarray, grads: torch.Tensor):
        """Adam update of the sampled views' se(3) deltas, outside the step."""
        t = max(self.step + 1, 1)
        for view, grad in zip(views.tolist(), grads):
            mu = CAM_B1 * self._cam_mu[view] + (1 - CAM_B1) * grad
            nu = CAM_B2 * self._cam_nu[view] + (1 - CAM_B2) * grad * grad
            step_v = (self.cfg.lr_camera * (mu / (1 - CAM_B1**t))
                      / (torch.sqrt(nu / (1 - CAM_B2**t)) + CAM_EPS))
            self._cam_mu[view] = mu
            self._cam_nu[view] = nu
            self.cam_deltas[view] -= step_v

    @torch.no_grad()
    def adjusted_viewmats(self) -> np.ndarray:
        """World-to-camera matrices with the learned pose corrections applied
        (the deltas are replicated: every rank holds them)."""
        return np.stack([
            apply_camera_delta(self.viewmats[i], self.cam_deltas[i]).cpu().numpy()
            for i in range(self.viewmats.shape[0])])

    def _maybe_refine(self):
        d = self.cfg.densify
        if not (d.refine_start <= self.step < d.refine_stop):
            return
        if self.step % d.refine_every == 0:
            params, adam, dstate = self._full_state()
            params, adam, dstate, _ = refine(params, adam, dstate, self.generator,
                                             self.scene_scale, d, self.step)
            self._set_full_state(params, adam, dstate)
        if self.step % d.reset_opacity_every == 0:
            self.params, self.adam = reset_opacity(self.params, self.adam,
                                                   d.reset_opacity_value)

    def _gather(self, tree: dict) -> dict:
        return {k: self.mesh.all_gather(v, "gauss") for k, v in tree.items()}

    def _full_state(self):
        """(params, adam, dstate) gathered over the gauss axis."""
        adam = AdamState(mu=self._gather(self.adam.mu), nu=self._gather(self.adam.nu),
                         count=self.adam.count)
        return self._gather(self.params), adam, DensifyState(*self._gather(
            self.dstate._asdict()).values())

    def _set_full_state(self, params: Params, adam: AdamState, dstate: DensifyState):
        """Keep this rank's shard of a full state."""
        self.params = shard_params(params, self.mesh)
        self.adam = AdamState(mu=shard_params(adam.mu, self.mesh),
                              nu=shard_params(adam.nu, self.mesh),
                              count=adam.count.to(self.device))
        self.dstate = DensifyState(*shard_params(dstate._asdict(), self.mesh).values())

    def host_params(self) -> Params:
        """The full parameters on the host (a collective: every rank calls it)."""
        return {k: v.cpu() for k, v in self._gather(self.params).items()}

    def num_alive(self) -> int:
        return int(self.mesh.all_gather(self.params["alive"], "gauss").sum())

    def cloud(self):
        return params_to_cloud(self.host_params())

    # ---------- checkpointing: the full state gathered, written by rank 0 in
    # the single-card Trainer's torch.save format, restored on every rank ----------

    def _ckpt_state(self) -> dict:
        params, adam, dstate = self._full_state()

        def host(tree):
            return {k: v.cpu() for k, v in tree.items()}

        return {
            "params": host(params),
            "adam_mu": host(adam.mu),
            "adam_nu": host(adam.nu),
            "adam_count": adam.count.cpu(),
            "dstate_grad": dstate.grad_accum.cpu(),
            "dstate_count": dstate.count_accum.cpu(),
            "cam_deltas": self.cam_deltas.cpu(),
            "cam_mu": self._cam_mu.cpu(),
            "cam_nu": self._cam_nu.cpu(),
            "step": self.step,
            "generator": self.generator.get_state(),
            "key": self.keys.get_state(),
        }

    def _barrier(self):
        if self.device.type == "cuda" and dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def save_checkpoint(self, directory: str):
        """Write a resumable checkpoint at the current step (a collective:
        every rank calls it; rank 0 writes, and no rank returns before the
        file is complete)."""
        state = self._ckpt_state()
        root = os.path.abspath(directory)
        path = os.path.join(root, f"step_{self.step:08d}.pt")
        if self.mesh.rank == 0:
            os.makedirs(root, exist_ok=True)
            tmp = path + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)
            with open(os.path.join(root, f"meta_{self.step:08d}.json"), "w") as f:
                json.dump({"capacity": int(state["params"]["means"].shape[0]),
                           "n_views": int(self.cam_deltas.shape[0]), "step": self.step}, f)
            self.log(f"checkpoint saved: {path}")
        self._barrier()

    def load_checkpoint(self, directory: str, step: Optional[int] = None):
        """Restore the latest (or given-step) checkpoint on this rank; a
        checkpoint of another capacity or view count is rejected."""
        path, _ = checkpoint_path(directory, step)
        state = torch.load(path, map_location="cpu", weights_only=True)
        capacity = self.params["means"].shape[0] * self.mesh.shape["gauss"]
        if state["params"]["means"].shape[0] != capacity:
            raise ValueError(f"checkpoint capacity {state['params']['means'].shape[0]} != "
                             f"trainer capacity {capacity}; cannot resume")
        if state["cam_deltas"].shape[0] != self.cam_deltas.shape[0]:
            raise ValueError(f"checkpoint has {state['cam_deltas'].shape[0]} views, trainer "
                             f"has {self.cam_deltas.shape[0]}; input set changed, cannot resume")
        self._set_full_state(
            state["params"],
            AdamState(mu=state["adam_mu"], nu=state["adam_nu"], count=state["adam_count"]),
            DensifyState(grad_accum=state["dstate_grad"], count_accum=state["dstate_count"]))
        self.cam_deltas = state["cam_deltas"].to(self.device)
        self._cam_mu = state["cam_mu"].to(self.device)
        self._cam_nu = state["cam_nu"].to(self.device)
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
        self.keys.set_state(state["key"])
        self.log(f"checkpoint restored: {path}")


def _train_rank(rank: int, device: torch.device, log, params: Params, images: np.ndarray,
                masks: Optional[np.ndarray], viewmats: np.ndarray, intrinsics: np.ndarray,
                scene_scale: float, cfg: TrainConfig, seed: int,
                checkpoint_dir: Optional[str], resume: bool):
    """One rank of train_splat(distributed=True); rank 0 returns the trained
    parameters (host) and the adjusted training poses."""
    trainer = DistributedTrainer(params, images, viewmats, intrinsics, scene_scale, cfg,
                                 seed=seed, masks=masks, log_fn=log, device=device)
    # gsplat's steps_scaler semantics (main.py:1322-1338): each step consumes
    # `batch` views, so the step count and every step-indexed milestone shrink
    trainer.cfg = scale_schedule(cfg, trainer.batch)
    if checkpoint_dir:
        trainer.checkpoint_dir = checkpoint_dir
        if resume:
            try:
                trainer.load_checkpoint(checkpoint_dir)
            except FileNotFoundError:
                pass
            except (ValueError, RuntimeError, KeyError) as e:  # incompatible: restart
                trainer.log(f"checkpoint restore failed ({e}); training from scratch")
    trainer.run(trainer.cfg.max_steps - trainer.step)
    out = trainer.host_params(), trainer.adjusted_viewmats()
    return out if rank == 0 else None


def train_distributed(params: Params, images: np.ndarray, masks: Optional[np.ndarray],
                      viewmats: np.ndarray, intrinsics: np.ndarray, scene_scale: float,
                      cfg: TrainConfig, seed: int, checkpoint_dir: Optional[str], resume: bool,
                      log_fn, device: torch.device, world_size: Optional[int] = None):
    """Train on one rank per card: NCCL ranks on cuda:0..n-1 (n = every card
    unless world_size says fewer), or, on the CPU, world_size gloo ranks.
    Builds the kernel library here first, so the ranks do not each run nvcc.
    Returns rank 0's (full parameters on the host, adjusted viewmats); raises
    if any rank fails."""
    from tpu_splat_torch import kernel_build
    from tpu_splat_torch.mesh.launch import spawn_ranks

    if device.type == "cuda":
        n = world_size or torch.cuda.device_count()
        if n > torch.cuda.device_count():
            raise ValueError(f"{n} ranks but {torch.cuda.device_count()} cards")
        kernel_build.build("composite")
        backend, devices, threads = "nccl", [f"cuda:{r}" for r in range(n)], None
    else:
        if not world_size:
            raise ValueError("distributed training on the CPU needs world_size (gloo ranks)")
        n = world_size
        backend, devices = "gloo", ["cpu"] * n
        threads = max(1, torch.get_num_threads() // n)
    if log_fn:
        log_fn(f"distributed training: {n} {backend} ranks on {', '.join(devices)}")
    # numpy crosses to the ranks by value (a tensor would go through shared
    # memory, which a container may keep small)
    params = {k: v.cpu().numpy() for k, v in params.items()}
    results = spawn_ranks(_train_rank, (params, images, masks, viewmats, intrinsics,
                                        scene_scale, cfg, seed, checkpoint_dir, resume),
                          backend, devices, num_threads=threads, log_fn=log_fn)
    return results[0]
