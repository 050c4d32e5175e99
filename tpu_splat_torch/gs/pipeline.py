"""Bridge from SfM output to 3DGS training (the port of tpu_splat/gs/pipeline.py):
builds training data from an SfMScene, applies the image-count downscale
policy, sizes the capacity, runs the Trainer (or, with distributed=True, one
DistributedTrainer rank per card) and returns the trained GaussianCloud with
held-out PSNR."""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.core.types import GaussianCloud, SfMScene, to_numpy
from tpu_splat_torch.gs.losses import psnr
from tpu_splat_torch.gs.params import init_params_from_points, params_to_cloud
from tpu_splat_torch.gs.render import render_view
from tpu_splat_torch.gs.trainer import TrainConfig, Trainer

MAX_TRAIN_DIM = 1600  # training resolution cap
EVAL_HOLD = 8  # hold out every 8th view when the capture is big enough


def auto_downscale_factor(n_images: int, max_dim: int = 0) -> int:
    """>= 250 images -> 1/4, >= 120 -> 1/2, then halve until under 1600 px."""
    factor = 4 if n_images >= 250 else 2 if n_images >= 120 else 1
    while max_dim and max_dim / factor > MAX_TRAIN_DIM:
        factor *= 2
    return factor


def _area_matrix(n_src: int, n_dst: int) -> torch.Tensor:
    """(n_dst, n_src) weights of area resampling: each output pixel averages
    the input interval [i*s, (i+1)*s), s = n_src/n_dst, by overlap length."""
    s = n_src / n_dst
    lo = np.arange(n_dst)[:, None] * s
    src = np.arange(n_src)[None, :]
    overlap = np.clip(np.minimum(lo + s, src + 1) - np.maximum(lo, src), 0.0, None)
    return torch.from_numpy((overlap / s).astype(np.float32))


def downscale_images(images: np.ndarray, factor: int) -> np.ndarray:
    """(M, H, W[, C]) -> (M, H//f, W//f[, C]) by area averaging, the
    resampling OpenCV's INTER_AREA does (an exact box average when f divides
    the size). Runs on the host."""
    if factor <= 1:
        return images
    h, w = images.shape[1:3]
    ah = _area_matrix(h, h // factor)
    aw = _area_matrix(w, w // factor)
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
    y = torch.einsum("ih,mhw...->miw...", ah, x)
    y = torch.einsum("jw,miw...->mij...", aw, y)
    return y.numpy()


def eval_split(n_images: int) -> np.ndarray:
    """Held-out view indices: every EVAL_HOLD-th view when the capture can
    spare them; empty otherwise."""
    if n_images >= 2 * EVAL_HOLD:
        return np.arange(0, n_images, EVAL_HOLD)
    return np.empty(0, np.int64)


@torch.no_grad()
def _psnr_over_views(params, viewmats, intrin, imgs, idx, sh_degree, cfg, device) -> float:
    vals = []
    for i in idx:
        out = render_view(
            params["means"], params["scales"], params["quats"], params["opacities"],
            params["sh0"], params["shN"], torch.as_tensor(viewmats[i], device=device),
            *(float(v) for v in intrin[i]), imgs.shape[2], imgs.shape[1],
            sh_degree=sh_degree, background=torch.zeros(3, device=device),
            max_per_tile=cfg.max_per_tile, alive=params["alive"], device=device,
        )
        vals.append(float(psnr(out.color, torch.as_tensor(imgs[i], device=device))))
    return float(np.mean(vals))


def train_splat(
    scene: SfMScene,
    images: np.ndarray,
    model: str = "splatfacto",
    max_steps: int = 30000,
    downscale_factor: int = 0,
    masks: Optional[np.ndarray] = None,
    sh_degree: int = 3,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    checkpoint_every: int = 0,
    distributed: bool = False,
    log_fn=None,
    device=None,
    world_size: Optional[int] = None,
) -> Tuple[GaussianCloud, Dict[str, float]]:
    """Train a splat from SfM output. images must align with scene.cameras.

    distributed=True trains data-parallel on one rank per card (NCCL; every
    card unless world_size says fewer), spawned from this process, with the
    step schedule shrunk by the batch (scale_schedule); on the CPU it runs
    world_size gloo ranks. Evaluation runs here, on `device`."""
    dev = resolve_device(device)
    n_img = images.shape[0]
    factor = downscale_factor or auto_downscale_factor(
        n_img, max_dim=max(images.shape[1], images.shape[2]))
    imgs = downscale_images(images.astype(np.float32), factor)
    if masks is not None and factor > 1:
        masks = downscale_images(masks.astype(np.float32), factor)

    cams = scene.cameras
    viewmats = np.asarray(cams.worldtocams, np.float32)
    intrin = np.stack([to_numpy(cams.fx), to_numpy(cams.fy), to_numpy(cams.cx),
                       to_numpy(cams.cy)], axis=1) / float(factor)

    pts = to_numpy(scene.points)
    colors = np.clip(to_numpy(scene.point_colors), 0.0, 1.0)
    scene_scale = float(np.mean(np.linalg.norm(pts - pts.mean(0), axis=1))) * 1.1

    # room to densify ~16x from the sparse init, power-of-two sized
    capacity = 1 << int(math.ceil(math.log2(max(len(pts) * 16, 4096))))
    # the ranks get their parameters from the host
    params = init_params_from_points(pts, colors, capacity=capacity, sh_degree=sh_degree,
                                     device="cpu" if distributed else dev)

    hold = eval_split(n_img)
    train_idx = np.setdiff1d(np.arange(n_img), hold)
    cfg = TrainConfig.for_model(model, max_steps=max_steps)
    if checkpoint_every:
        cfg = replace(cfg, checkpoint_every=checkpoint_every)

    t_masks = masks[train_idx] if masks is not None else None
    # train views are evaluated with their refined poses, held-out views
    # keep their SfM poses
    eval_viewmats = viewmats.copy()
    if distributed:
        from tpu_splat_torch.mesh.trainer import train_distributed

        host_params, eval_viewmats[train_idx] = train_distributed(
            params, imgs[train_idx], t_masks, viewmats[train_idx], intrin[train_idx],
            scene_scale, cfg, seed, checkpoint_dir, resume, log_fn, dev, world_size)
        eval_params = {k: v.to(dev) for k, v in host_params.items()}
        cloud = params_to_cloud(host_params)
    else:
        trainer = Trainer(
            params, imgs[train_idx], viewmats[train_idx], intrin[train_idx],
            scene_scale=scene_scale, cfg=cfg, seed=seed, masks=t_masks, log_fn=log_fn,
            device=dev,
        )
        if checkpoint_dir:
            trainer.checkpoint_dir = checkpoint_dir
            if resume:
                try:
                    trainer.load_checkpoint(checkpoint_dir)
                except FileNotFoundError:
                    pass
                except (ValueError, RuntimeError, KeyError) as e:  # incompatible: restart
                    if log_fn:
                        log_fn(f"checkpoint restore failed ({e}); training from scratch")
        trainer.run(max_steps - trainer.step)
        eval_viewmats[train_idx] = trainer.adjusted_viewmats()
        eval_params = trainer.params
        cloud = trainer.cloud()
    metrics = {
        "num_gaussians": float(cloud.num_points),
        "train_steps": float(max_steps),
        "downscale_factor": float(factor),
    }
    deg = min(sh_degree, cloud.sh_degree)
    if len(hold):
        metrics["psnr"] = _psnr_over_views(eval_params, eval_viewmats, intrin, imgs,
                                           hold, deg, cfg, dev)
        metrics["eval_views"] = float(len(hold))
    else:  # too small for a held-out split: report train-view PSNR
        idx = range(0, len(train_idx), max(len(train_idx) // 4, 1))
        metrics["psnr"] = _psnr_over_views(eval_params, eval_viewmats, intrin, imgs,
                                           [train_idx[i] for i in idx], deg, cfg, dev)
        metrics["eval_views"] = 0.0
    return cloud, metrics
