"""Multi-card training: the device mesh and the sharded train step (the port
of tpu_splat/mesh/distributed.py).

The mesh has the reference's two axes over the ranks of an initialised
torch.distributed process group, rank = d * n_gauss + g:

- "data": view-batch parallelism. Each data row renders its own views; the
  loss and the gradients are averaged over the axis.
- "gauss": the gaussian axis is sharded (ZeRO-style). Parameters and optimizer
  state live in shards of N / n_gauss rows, are all-gathered for rendering,
  and each rank updates only its own rows.

The reference writes the step as one shard_map program. Here every rank runs
the step body, and each collective is an explicit torch.distributed call on a
subgroup of the mesh. A sum over ranks is an all-gather followed by adds in
rank order, so no result depends on the order in which ranks arrive and every
replica holds the same bits. gloo collectives take host tensors: a CUDA buffer
bound for one is staged through host memory, while rendering and the kernels
stay on the card. Learning rates are kept and the global batch grows with the
data axis; train_splat shrinks the step schedule to match (scale_schedule).
"""

from __future__ import annotations

from functools import reduce
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.gs.losses import image_loss
from tpu_splat_torch.gs.optim import AdamState, adam_update
from tpu_splat_torch.gs.projection import project_gaussians
from tpu_splat_torch.gs.render import render_view
from tpu_splat_torch.gs.strategy import DensifyState, accumulate_gradients
from tpu_splat_torch.gs.trainer import _lr_tree, apply_camera_delta

Params = Dict[str, torch.Tensor]


def rank_device(device=None) -> torch.device:
    """The rank's device: the current card unless the caller names one (each
    rank calls torch.cuda.set_device on its own card first)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A (data, gauss) mesh over the default process group. Every rank builds
    one subgroup per data row (the gauss axis) and one per gauss column (the
    data axis), in the same order."""

    def __init__(self, n_data: int, n_gauss: int, device: torch.device):
        world = dist.get_world_size()
        if n_data * n_gauss != world:
            raise ValueError(f"{n_data}x{n_gauss} != {world} ranks")
        self.shape = {"data": n_data, "gauss": n_gauss}
        self.rank = dist.get_rank()
        self.coords = {"data": self.rank // n_gauss, "gauss": self.rank % n_gauss}
        self.device = device
        self._stage = dist.get_backend() == "gloo" and device.type == "cuda"
        self._groups = {}
        for d in range(n_data):
            group = dist.new_group([d * n_gauss + g for g in range(n_gauss)])
            if d == self.coords["data"]:
                self._groups["gauss"] = group
        for g in range(n_gauss):
            group = dist.new_group([d * n_gauss + g for d in range(n_data)])
            if g == self.coords["gauss"]:
                self._groups["data"] = group

    def gather(self, x: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """Every rank's x along `axis`, in axis order. The bytes travel as
        uint8, so bool and bf16 tensors cross any backend unchanged."""
        n = self.shape[axis]
        if n == 1:
            return [x]
        if x.numel() == 0:
            return [x] * n
        raw = x.contiguous().reshape(x.shape or (1,)).view(torch.uint8)
        if self._stage:
            raw = raw.cpu()
        parts = [torch.empty_like(raw) for _ in range(n)]
        dist.all_gather(parts, raw, group=self._groups[axis])
        return [p.to(x.device).view(x.dtype).reshape(x.shape) for p in parts]

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Concatenate the axis' shards along dim 0."""
        parts = self.gather(x, axis)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def mean(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The mean over the axis, summed in rank order."""
        parts = self.gather(x, axis)
        return parts[0] if len(parts) == 1 else reduce(torch.add, parts) / len(parts)

    def max(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        parts = self.gather(x, axis)
        return parts[0] if len(parts) == 1 else torch.stack(parts).amax(0)

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full (N, ...) tensor along the gauss axis."""
        n_gauss, g = self.shape["gauss"], self.coords["gauss"]
        if x.shape[0] % n_gauss:
            raise ValueError(f"{x.shape[0]} rows do not split over {n_gauss} gauss shards")
        n = x.shape[0] // n_gauss
        return x[g * n:(g + 1) * n]


def make_mesh(n_data: Optional[int] = None, n_gauss: int = 1, device=None) -> Mesh:
    """The mesh over the initialised default process group; n_data defaults to
    world size // n_gauss. `device` is the rank's (its current card unless
    given)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_gauss
    return Mesh(n_data, n_gauss, rank_device(device))


def shard_params(params: Params, mesh: Mesh) -> Params:
    """This rank's shard of every parameter, along the gaussian axis (axis 0),
    on the mesh's device; replicated across the data axis."""
    return {k: mesh.shard_rows(torch.as_tensor(v)).to(mesh.device).clone()
            for k, v in params.items()}


def make_distributed_train_step(mesh: Mesh, cfg, width: int, height: int,
                                active_sh_degree: int, scene_scale: float,
                                use_masks: bool = False):
    """The sharded train step, with the reference's signature:

    step_fn(params, adam, dstate, images (B,H,W,3), viewmats (B,4,4), intrins
    (B,4), masks (B,H,W), cam_deltas (B,6), step, key)
    -> (params, adam, dstate, metrics, cam_grads (B,6)).

    Every rank passes the whole batch and its own shards of params, adam and
    dstate; it renders views [d*B/n_data, (d+1)*B/n_data) of data row d. B must
    be a multiple of the data-axis size. When use_masks is False the masks
    argument is ignored (pass a (B,1,1) dummy); cam_grads are zero unless
    cfg.optimize_camera_poses. `key` (an int) seeds the random background of
    each data row. Adam is the reference's: bias-corrected, no selective
    update, no regularisers.
    """
    n_data = mesh.shape["data"]
    d_row = mesh.coords["data"]
    opt_cams = cfg.optimize_camera_poses

    def per_view_loss(full, alive, image, viewmat, intrin, dummy, bg, mask, cam_delta):
        out = render_view(
            full["means"], full["scales"], full["quats"], full["opacities"], full["sh0"],
            full["shN"], apply_camera_delta(viewmat, cam_delta), *intrin, width, height,
            sh_degree=active_sh_degree, background=bg, antialiased=cfg.antialiased,
            tile_size=cfg.tile_size, max_per_tile=cfg.max_per_tile, means2d_dummy=dummy,
            alive=alive, device=mesh.device,
        )
        gt = image
        alpha_loss = 0.0
        if use_masks:
            # the single-card train_step's masked-capture semantics
            m = mask[..., None]
            gt = gt * m + bg * (1.0 - m)
            alpha_loss = torch.mean(torch.abs(out.alpha - mask))
        return image_loss(out.color, gt, cfg.ssim_lambda) + 0.1 * alpha_loss

    def step_fn(params: Params, adam: AdamState, dstate: DensifyState, images, viewmats,
                intrins, masks, cam_deltas, step: int, key: int):
        dev = mesh.device
        n_batch = images.shape[0]
        if n_batch % n_data:
            raise ValueError(f"batch {n_batch} is not a multiple of the data axis {n_data}")
        per_row = n_batch // n_data
        mine = range(d_row * per_row, (d_row + 1) * per_row)
        intr = (intrins.detach().cpu().numpy() if isinstance(intrins, torch.Tensor)
                else np.asarray(intrins, np.float32))

        # the full parameters, gathered over the gauss axis, for rendering
        full = {k: mesh.all_gather(v, "gauss") for k, v in params.items()}
        alive = full.pop("alive")
        capacity = alive.shape[0]
        if cfg.random_background:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(key) * n_data + d_row)
            bg = torch.rand(3, generator=gen, device=dev)
        else:
            bg = torch.zeros(3, device=dev)

        trainable = {k: v.detach().requires_grad_(True) for k, v in full.items()}
        dummy = torch.zeros((capacity, 2), device=dev, requires_grad=True)
        cds = cam_deltas[mine.start:mine.stop].detach().clone().requires_grad_(opt_cams)
        losses = [per_view_loss(trainable, alive, images[i], viewmats[i],
                                [float(v) for v in intr[i]], dummy, bg, masks[i],
                                cds[i - mine.start]) for i in mine]
        loss = torch.stack(losses).mean()
        names = list(trainable)
        inputs = [trainable[k] for k in names] + [dummy] + ([cds] if opt_cams else [])
        # a degree-0 cloud has an empty shN that the render never reads
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, torch.autograd.grad(loss, inputs, allow_unused=True))]

        with torch.no_grad():
            # average over the data axis; Adam zeroes the dead slots' gradients
            loss = mesh.mean(loss.detach(), "data")
            pgrads = {k: mesh.mean(g, "data") for k, g in zip(names, grads)}
            g2d = mesh.mean(grads[len(names)], "data")

            # visibility for densify accumulation: any view of the batch
            radii = torch.stack([
                project_gaussians(full["means"], full["scales"], full["quats"], viewmats[i],
                                  *[float(v) for v in intr[i]], width, height).radii
                for i in mine]).amax(0)
            radii = mesh.max(radii, "data")
            radii = torch.where(alive, radii, torch.zeros_like(radii))

            # Adam and the densify statistics on this rank's shard
            lrs = _lr_tree(cfg, scene_scale, int(step), cfg.max_steps)
            shard = {k: params[k] for k in adam.mu}
            new_shard, adam = adam_update(shard, {k: mesh.shard_rows(pgrads[k]) for k in shard},
                                          adam, lrs, grad_mask=mesh.shard_rows(alive))
            new_params = dict(params)
            new_params.update(new_shard)
            dstate = accumulate_gradients(dstate, mesh.shard_rows(g2d), mesh.shard_rows(radii),
                                          width, height)
            cam_grads = (mesh.all_gather(grads[-1], "data") if opt_cams
                         else torch.zeros_like(cam_deltas))
        return new_params, adam, dstate, {"loss": loss}, cam_grads

    return step_fn
