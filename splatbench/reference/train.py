"""Plain PyTorch training of a splat, step by step: the loss (L1 + D-SSIM),
its gradients by autograd through `render.render`, Adam over the parameter
leaves (selective where the configuration says so, shN's first moment kept
in bf16), the per-view camera-pose Adam, the densify accumulators, and the
refine pass (duplicate, split, prune into dead slots) with its opacity reset
and capacity growth; and `work`, what a step on the snapshot costs by the
same equations, which the kernels' roofline shares and the step's share of
the peak are read against.

The settings come from the configuration file's `train` block, which states
the job's training configuration; nothing here reads the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from splatbench import counts
from splatbench.reference import render as R

LEAVES = ("means", "scales", "quats", "opacities", "sh0", "shN")
B1, B2, EPS = 0.9, 0.999, 1e-8
BF16_MU = ("shN",)


def blur_band(n: int, window: int = 11, sigma: float = 1.5) -> np.ndarray:
    """(n, n) banded gaussian blur (zero-padded SAME), the separable SSIM window."""
    x = np.arange(window) - window // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    band = np.zeros((n, n), np.float32)
    for o, w in zip(x, g):
        band += w * np.eye(n, k=int(o), dtype=np.float32)
    return band


def image_loss(pred, gt, ssim_lambda: float) -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM), SSIM with an 11-tap sigma-1.5
    window as two band-matrix products a map."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    h, w, c = pred.shape
    bw = torch.from_numpy(blur_band(w)).to(pred.device)
    bh = torch.from_numpy(blur_band(h)).to(pred.device)

    def conv(x):
        y = R.mm(x.permute(2, 0, 1).reshape(c * h, w), bw)
        y = R.mm(y.reshape(c, h, w).transpose(1, 2).reshape(c * w, h), bh)
        return y.reshape(c, w, h).permute(2, 1, 0)

    mu1, mu2 = conv(pred), conv(gt)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = conv(pred * pred) - mu1_sq
    s2 = conv(gt * gt) - mu2_sq
    s12 = conv(pred * gt) - mu12
    ssim = torch.mean((2 * mu12 + c1) * (2 * s12 + c2)
                      / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))
    return (1.0 - ssim_lambda) * torch.mean(torch.abs(pred - gt)) + ssim_lambda * (1.0 - ssim)


class State(NamedTuple):
    params: Dict[str, torch.Tensor]   # LEAVES + "alive"
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int
    grad_accum: torch.Tensor
    count_accum: torch.Tensor
    cam: torch.Tensor                 # (V, 6) pose deltas
    cam_mu: torch.Tensor
    cam_nu: torch.Tensor


def initial_state(params: Dict[str, torch.Tensor], n_views: int) -> State:
    """Zero optimizer, densify and camera state around cloned params."""
    p = {k: v.clone() for k, v in params.items()}
    dev = p["means"].device
    mu = {k: torch.zeros(p[k].shape, device=dev,
                         dtype=torch.bfloat16 if k in BF16_MU else torch.float32)
          for k in LEAVES}
    nu = {k: torch.zeros_like(p[k]) for k in LEAVES}
    n = p["means"].shape[0]
    z = torch.zeros((n_views, 6), device=dev)
    return State(p, mu, nu, 0, torch.zeros(n, device=dev), torch.zeros(n, device=dev),
                 z, z.clone(), z.clone())


def k_tile(tc: dict, step: int) -> int:
    """Tiles keep 4x K (at most 1024) before the first opacity reset and the
    post-reset K within its recovery window after one; K otherwise."""
    d = tc["densify"]
    warm = tc["warmup_max_per_tile"] or min(4 * tc["max_per_tile"], 1024)
    if d["reset_opacity_every"] > 0 and warm > tc["max_per_tile"] \
            and step < min(d["reset_opacity_every"], d["refine_stop"]):
        return warm
    if tc["post_reset_max_per_tile"] <= tc["max_per_tile"] or d["reset_opacity_every"] <= 0:
        return tc["max_per_tile"]
    last = (step // d["reset_opacity_every"]) * d["reset_opacity_every"]
    if (d["refine_start"] <= last < d["refine_stop"] and last > 0
            and step - last < tc["post_reset_recover_steps"]):
        return tc["post_reset_max_per_tile"]
    return tc["max_per_tile"]


def learning_rates(tc: dict, scene_scale: float, step: int) -> Dict[str, float]:
    """Means decay exponentially from lr_means x scene scale to lr_means_final
    over max_steps (in f32); the other leaves keep their rates."""
    t = np.clip(np.float32(step) / np.float32(tc["max_steps"]), np.float32(0), np.float32(1))
    decay = np.float32(tc["lr_means_final"] / tc["lr_means"]) ** t
    return {"means": float(np.float32(tc["lr_means"] * scene_scale) * decay),
            "scales": tc["lr_scales"], "quats": tc["lr_quats"],
            "opacities": tc["lr_opacities"], "sh0": tc["lr_sh0"], "shN": tc["lr_shN"]}


def _rows(mask, ndim):
    return mask.reshape((-1,) + (1,) * (ndim - 1))


class StepOut(NamedTuple):
    state: State
    loss: float


def step(s: State, tc: dict, image, viewmat, intrin, view: int, step_i: int,
         generator: torch.Generator, scene_scale: float, width: int, height: int,
         half_batch: bool = False) -> StepOut:
    """One training step on one view. half_batch (a planted fault) takes the
    loss over the top half of the image only."""
    p, alive = s.params, s.params["alive"]
    dev = alive.device
    leaves = {k: p[k].detach().requires_grad_(True) for k in LEAVES}
    cd = s.cam[view].detach().requires_grad_(tc["optimize_camera_poses"])
    bg = (torch.rand(3, generator=generator, device=dev) if tc["random_background"]
          else torch.zeros(3, device=dev))
    offset = torch.zeros((alive.shape[0], 2), device=dev, requires_grad=True)
    sh_deg = min(step_i // tc["sh_degree_interval"], tc["sh_degree"])
    out = R.render(leaves["means"], leaves["scales"], leaves["quats"], leaves["opacities"],
                   leaves["sh0"], leaves["shN"], R.apply_camera_delta(viewmat, cd), intrin,
                   width, height, sh_deg, k_tile(tc, step_i), background=bg,
                   antialiased=tc["antialiased"], alive=alive, means2d_offset=offset)
    rows = slice(0, height // 2) if half_batch else slice(None)
    loss = image_loss(out.color[rows], image[rows], tc["ssim_lambda"])
    inputs = [leaves[k] for k in LEAVES] + [offset] + ([cd] if cd.requires_grad else [])
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    with torch.no_grad():
        g = {k: torch.where(_rows(alive, gr.ndim), gr, torch.zeros_like(gr))
             for k, gr in zip(LEAVES, grads)}
        # visibility from the pose without its delta, with the 3-sigma extent
        fx, fy, cx, cy = (float(v) for v in intrin)
        radii = R.project(p["means"], p["scales"], p["quats"], viewmat, fx, fy, cx, cy,
                          width, height).radii
        radii = torch.where(alive, radii, torch.zeros_like(radii))
        visible = radii > 0
        count = s.count + 1
        c = torch.tensor(float(count), device=dev)
        bc1, bc2 = 1.0 - torch.pow(B1, c), 1.0 - torch.pow(B2, c)
        lrs = learning_rates(tc, scene_scale, step_i)
        new_p, mu, nu = dict(p), {}, {}
        for k in LEAVES:
            m_old, v_old = s.mu[k].float(), s.nu[k]
            m = B1 * m_old + (1 - B1) * g[k]
            v = B2 * v_old + (1 - B2) * (g[k] * g[k])
            upd = lrs[k] * (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            if tc["selective_adam"]:
                vis = _rows(visible, m.ndim)
                m, v = torch.where(vis, m, m_old), torch.where(vis, v, v_old)
                upd = torch.where(vis, upd, torch.zeros_like(upd))
            mu[k] = m.to(s.mu[k].dtype)
            nu[k] = v
            new_p[k] = p[k] - upd
        d2 = grads[len(LEAVES)]
        gn = torch.linalg.norm(torch.stack([d2[:, 0] * (width / 2.0),
                                            d2[:, 1] * (height / 2.0)], -1), dim=-1)
        grad_accum = s.grad_accum + torch.where(visible, gn, torch.zeros_like(gn))
        count_accum = s.count_accum + visible.float()
        cam, cam_mu, cam_nu = s.cam.clone(), s.cam_mu.clone(), s.cam_nu.clone()
        if cd.requires_grad:
            gc = grads[-1]
            m = B1 * cam_mu[view] + (1 - B1) * gc
            v = B2 * cam_nu[view] + (1 - B2) * gc * gc
            t = max(step_i, 1)
            cam[view] -= (tc["lr_camera"] * (m / (1 - B1 ** t))
                          / (torch.sqrt(v / (1 - B2 ** t)) + EPS))
            cam_mu[view], cam_nu[view] = m, v
    return StepOut(State(new_p, mu, nu, count, grad_accum, count_accum, cam, cam_mu, cam_nu),
                   float(loss.detach()))


@torch.no_grad()
def refine(s: State, tc: dict, generator: torch.Generator, scene_scale: float,
           step_i: int) -> State:
    """Duplicate small and split large gaussians whose mean screen gradient
    passes the threshold, into dead slots in index order; prune transparent
    ones (and world-space giants after the first reset); zero the moved
    slots' moments and the accumulators. A split draws two (N, 3) normal
    offsets, the child's and then the parent's, scaled by the gaussian's
    axes and rotated into the world."""
    d = tc["densify"]
    p, alive = s.params, s.params["alive"]
    cap = alive.shape[0]
    avg = s.grad_accum / torch.clamp_min(s.count_accum, 1.0)
    cand = alive & (s.count_accum > 0) & (avg > d["grad_threshold"])
    smax = torch.exp(p["scales"].amax(dim=-1))
    is_split = cand & (smax > d["split_scale_threshold"] * scene_scale)
    is_dup = cand & ~is_split
    prune = alive & ((torch.sigmoid(p["opacities"]) < d["prune_opacity"])
                     | ((smax > d["prune_scale3d"] * scene_scale)
                        & (step_i > d["reset_opacity_every"])))
    is_split, is_dup, alive = is_split & ~prune, is_dup & ~prune, alive & ~prune
    req = is_split | is_dup
    rank = torch.cumsum(req.to(torch.int64), 0) - 1
    dead = torch.argsort(alive.to(torch.int32), stable=True)
    granted = req & (rank < (~alive).sum())
    target = torch.where(granted, dead[torch.clamp(rank, 0, cap - 1)],
                         torch.full_like(rank, cap))
    rot = R.quat_to_rotmat(p["quats"])
    std = torch.exp(p["scales"])

    def offset():
        local = torch.randn((cap, 3), generator=generator, device=std.device) * std
        return torch.einsum("nij,nj->ni", rot, local)

    def put(arr, vals):
        buf = torch.cat([arr, arr[:1]])
        buf[target] = vals
        return buf[:-1]

    split_col = is_split[:, None]
    split_scales = p["scales"] - math.log(d["split_factor"])
    child = {k: p[k] for k in LEAVES}
    child["means"] = torch.where(split_col, p["means"] + offset(), p["means"])
    child["scales"] = torch.where(split_col, split_scales, p["scales"])
    new = dict(p)
    new["means"] = torch.where(split_col, p["means"] + offset(), p["means"])
    new["scales"] = torch.where(split_col, split_scales, p["scales"])
    for k in LEAVES:
        new[k] = put(new[k], child[k])
    new["alive"] = put(alive, granted)
    reset = put(torch.zeros_like(alive), granted) | is_split | prune
    mu = {k: torch.where(_rows(reset, v.ndim), torch.zeros_like(v), v) for k, v in s.mu.items()}
    nu = {k: torch.where(_rows(reset, v.ndim), torch.zeros_like(v), v) for k, v in s.nu.items()}
    z = torch.zeros(cap, device=alive.device)
    s = s._replace(params=new, mu=mu, nu=nu, grad_accum=z, count_accum=z.clone())
    if int(new["alive"].sum()) > tc["grow_threshold"] * cap:
        s = grow(s, 2 * cap)
    return s


def grow(s: State, cap: int) -> State:
    """Pad every per-gaussian tensor with dead slots (unit quaternions)."""
    def pad(tree):
        return {k: torch.cat([v, v.new_zeros((cap - v.shape[0],) + v.shape[1:])])
                for k, v in tree.items()}

    p = pad(s.params)
    p["quats"][s.params["quats"].shape[0]:, 0] = 1.0
    z = torch.zeros(cap, device=s.grad_accum.device)
    return s._replace(params=p, mu=pad(s.mu), nu=pad(s.nu), grad_accum=z, count_accum=z.clone())


@torch.no_grad()
def after_chunk(s: State, tc: dict, generator, scene_scale: float, step_i: int) -> State:
    """The host's work where a chunk of steps ends at step_i: a refine pass
    on the refine schedule, then the opacity reset on its own."""
    d = tc["densify"]
    in_window = d["refine_start"] <= step_i < d["refine_stop"]
    if in_window and step_i % d["refine_every"] == 0:
        s = refine(s, tc, generator, scene_scale, step_i)
    if in_window and step_i % d["reset_opacity_every"] == 0:
        logit = float(np.log(np.float32(d["reset_opacity_value"]
                                        / (1.0 - d["reset_opacity_value"]))))
        p = dict(s.params)
        p["opacities"] = torch.clamp_max(p["opacities"], logit)
        mu, nu = dict(s.mu), dict(s.nu)
        mu["opacities"] = torch.zeros_like(mu["opacities"])
        nu["opacities"] = torch.zeros_like(nu["opacities"])
        s = s._replace(params=p, mu=mu, nu=nu)
    return s


def views_for(n_views: int, count: int) -> List[int]:
    """The views of a run's first chunk of steps: the trainer draws them
    from numpy's generator seeded 42 at the start of every run."""
    return [int(v) for v in np.random.default_rng(42).integers(n_views, size=count)]


class Followed(NamedTuple):
    losses: List[float]
    first: State      # after the first step
    before: State     # after the last step, before the chunk's end
    after: State      # after the chunk's end (refine, reset)


def follow(params, images, viewmats, intrinsics, scene_scale: float, tc: dict,
           start_step: int, n_steps: int, seed: int, half_batch: bool = False) -> Followed:
    """n_steps steps from the snapshot (params with zero state at start_step,
    the generator seeded `seed`), in one chunk, then the chunk's end."""
    unsupported = {k: tc[k] for k in ("scale_reg_weight", "opacity_reg_weight") if tc[k]}
    if tc["strategy"] != "default" or unsupported:
        raise ValueError(f"the reference follows the default strategy without "
                         f"regularisers, not {tc['strategy']!r} with {unsupported}")
    dev = params["means"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, w = images.shape[1:3]
    s = initial_state(params, images.shape[0])
    losses, first = [], None
    for i, v in enumerate(views_for(images.shape[0], n_steps)):
        s, loss = step(s, tc, images[v], viewmats[v], intrinsics[v], v, start_step + i, gen,
                       scene_scale, w, h, half_batch=half_batch)
        losses.append(loss)
        if first is None:
            first = s
    return Followed(losses, first, s,
                    after_chunk(s, tc, gen, scene_scale, start_step + n_steps))


@torch.no_grad()
def work(scene, tc: dict, tr: dict, k: int) -> dict:
    """The work of the snapshot's step, averaged over all training views, by
    the plain projection, binning and compositing (tile capacity k): pairs
    and bytes of a compositing launch, the step's f32 operations, the
    visible share."""
    p = scene.params
    alive = int(p["alive"].sum())
    tot: Dict[str, float] = {}
    visible = 0.0
    for v in range(scene.images.shape[0]):
        out = R.render(*(p[x] for x in LEAVES), scene.viewmats[v], scene.intrinsics[v],
                       tr["width"], tr["height"], tc["sh_degree"], k,
                       antialiased=tc["antialiased"], alive=p["alive"])
        for key, val in counts.composite_work(out.counts, out.reached, k).items():
            tot[key] = tot.get(key, 0.0) + val
        visible += float((out.radii > 0).sum()) / alive
    n = scene.images.shape[0]
    work = {key: val / n for key, val in tot.items()}
    elements = sum(int(p[x][0].numel()) for x in LEAVES)
    work["step_ops"] = counts.step_ops(alive, elements, tr["width"] * tr["height"],
                                       work["pairs"], tc["sh_degree"])
    work["visible_share"] = visible / n
    return work
