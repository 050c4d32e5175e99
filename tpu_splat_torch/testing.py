"""Seeded synthetic inputs for checking the port: a ring of cameras, a capture
of a ground-truth cloud rendered by the port, and the mixed-regime packed
tensor of scripts/check_kernel_parity.py. Used by the tests, chip_smoke.py
and scripts/compare_torch_train_splat.py; numpy in, numpy out."""

from __future__ import annotations

import numpy as np


def look_at(eye: np.ndarray) -> np.ndarray:
    """World-to-camera (4, 4) f32 for a camera at `eye` looking at the origin
    (+z forward, -y up)."""
    z = -eye / np.linalg.norm(eye)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.stack([x, np.cross(z, x), z])
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def ring_viewmats(n_views: int, radius: float, height: float = 0.8) -> np.ndarray:
    """(n_views, 4, 4) cameras evenly spaced on a horizontal ring, as bench.py
    places them."""
    return np.stack([look_at(np.array([radius * np.cos(a), height, radius * np.sin(a)]))
                     for a in np.linspace(0, 2 * np.pi, n_views, endpoint=False)])


def synthetic_capture(n: int = 60, width: int = 64, height: int = 48, focal: float = 60.0,
                      n_views: int = 16, radius: float = 3.5, seed: int = 7,
                      scale: float = 0.12, max_per_tile: int = 128, device="cpu"):
    """A ring capture of n round gaussians (std `scale`) of random colour in
    [-1, 1]^3, rendered by the port on `device`, and a noisy copy of their
    centres as the sparse point cloud to train from.

    Returns (viewmats (V, 4, 4), intrinsics (V, 4), images (V, H, W, 3),
    points (n, 3), point colours (n, 3)), all numpy f32."""
    import torch

    from tpu_splat_torch.gs.render import render_view

    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    gt = [means, np.full((n, 3), np.log(scale), np.float32),
          np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)),
          np.full((n,), 2.0, np.float32),
          ((rng.uniform(0, 1, (n, 3)) - 0.5) / 0.2820948).astype(np.float32),
          np.zeros((n, 0, 3), np.float32)]
    viewmats = ring_viewmats(n_views, radius)
    with torch.no_grad():
        gt_d = [torch.from_numpy(a).to(device) for a in gt]
        images = np.stack([
            render_view(*gt_d, torch.from_numpy(vm).to(device), focal, focal, width / 2,
                        height / 2, width, height, sh_degree=0,
                        background=torch.zeros(3, device=device), max_per_tile=max_per_tile,
                        device=device).color.cpu().numpy()
            for vm in viewmats])
    intrin = np.tile(np.array([[focal, focal, width / 2, height / 2]], np.float32),
                     (n_views, 1))
    pts = (means + rng.normal(0, 0.1, means.shape)).astype(np.float32)
    colors = rng.uniform(0.3, 0.7, (n, 3)).astype(np.float32)
    return viewmats, intrin, images, pts, colors


# Pair counts for build_packed's 12-tile fixture that put a tile on each edge
# of the backward's sweep: empty, one pair, both sides of a 16-gaussian
# segment and of a 128-gaussian chunk, and one short of K = 256.
RAGGED_COUNTS = (0, 1, 15, 16, 17, 127, 128, 129, 255, 256, 64, 200)


def build_packed(rng: np.random.Generator, t_total: int, k: int, width_tiles: int,
                 tile_size: int = 16, counts=None):
    """Packed (16, T, K) f32 tensor and (T,) int32 pair counts with mixed
    regimes per tile (the numpy twin of scripts/check_kernel_parity.py's):
    tile 1 near-empty (4 pairs), tile 2 saturating in its first chunk, tile 3
    never saturating, the rest mid-opacity. `counts` (T,) overrides the pair
    counts (K each, 4 for tile 1); the slots past a tile's count stay the
    zero sentinel row."""
    feat = np.zeros((16, t_total, k), np.float32)
    if counts is None:
        counts = [4 if t == 1 else k for t in range(t_total)]
    for t in range(t_total):
        tx0 = (t % width_tiles) * tile_size
        ty0 = (t // width_tiles) * tile_size
        n_g = int(counts[t])
        mx = tx0 + rng.uniform(-2, tile_size + 2, n_g)
        my = ty0 + rng.uniform(-2, tile_size + 2, n_g)
        if t == 2:
            op = rng.uniform(0.9, 0.999, n_g)
            scale = rng.uniform(1.5, 2.5, n_g)
        elif t == 3:
            op = rng.uniform(0.002, 0.01, n_g)
            scale = rng.uniform(2.0, 6.0, n_g)
        else:
            op = rng.uniform(0.05, 0.9, n_g)
            scale = rng.uniform(1.0, 6.0, n_g)
        ca = 1.0 / scale**2
        cc = 1.0 / (scale * rng.uniform(0.5, 1.5, n_g)) ** 2
        cb = rng.uniform(-0.2, 0.2, n_g) * np.sqrt(ca * cc)
        feat[0, t, :n_g] = mx
        feat[1, t, :n_g] = my
        feat[2, t, :n_g] = ca
        feat[3, t, :n_g] = cb
        feat[4, t, :n_g] = cc
        feat[5:8, t, :n_g] = rng.uniform(0, 1, (3, n_g))
        feat[8, t, :n_g] = op
        feat[9, t, :n_g] = rng.uniform(0.5, 8.0, n_g)
    return feat, np.asarray(counts, np.int32)


def walk_viewmats(n_views: int, span: float = 5.0, depth: float = 4.2) -> np.ndarray:
    """(n_views, 4, 4) world-to-camera matrices of a forward-facing lateral
    walk: the eye slides along x at z = -depth, looking at (0, 0.3, 0)."""
    mats = []
    for x in np.linspace(-span / 2, span / 2, n_views):
        eye = np.array([x, 0.3, -depth])
        z = np.array([0.0, 0.3, 0.0]) - eye
        z /= np.linalg.norm(z)
        xax = np.cross(np.array([0.0, -1.0, 0.0]), z)
        xax /= np.linalg.norm(xax)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.stack([xax, np.cross(z, xax), z])
        m[:3, 3] = -m[:3, :3] @ eye
        mats.append(m)
    return np.stack(mats)


def textured_scene(rng: np.random.Generator, n_rock: int = 20_000, n_plane: int = 40_000,
                   n_wall: int = 40_000, sizes: tuple = (0.01, 0.06), bimodal: bool = False):
    """A textured scene for SfM as numpy gaussian parameters (means,
    log-scales, quats, opacity logits, sh0, shN): a bumpy 'rock' on a ground
    plane (+y down) before a back wall, made of blobs whose sizes are
    log-uniform in `sizes` (metres) and whose colours are uniform, or, with
    `bimodal`, dark or light with a little jitter. The defaults are
    chip_smoke.py's phase-6 scene: texture distinctive at every scale."""
    dirs = rng.normal(size=(n_rock, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radius = (1.0 + 0.25 * np.sin(5 * dirs[:, 0]) * np.cos(4 * dirs[:, 1])
              + 0.05 * rng.normal(size=n_rock))
    means = np.concatenate([
        dirs * radius[:, None],
        np.stack([rng.uniform(-3, 3, n_plane),
                  np.full(n_plane, 1.3) + rng.normal(0, 0.02, n_plane),
                  rng.uniform(-3, 3, n_plane)], axis=1),
        np.stack([rng.uniform(-6, 6, n_wall), rng.uniform(-3, 1.3, n_wall),
                  np.full(n_wall, 3.5) + rng.normal(0, 0.02, n_wall)], axis=1)])
    n = len(means)
    log_s = rng.uniform(np.log(sizes[0]), np.log(sizes[1]), (n, 1))
    if bimodal:
        colors = np.clip(rng.choice([0.1, 0.9], size=(n, 1))
                         + rng.uniform(-0.1, 0.1, (n, 3)), 0, 1)
    else:
        colors = rng.uniform(0, 1, (n, 3))
    return [means.astype(np.float32), np.repeat(log_s, 3, 1).astype(np.float32),
            np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)),
            np.full((n,), 4.0, np.float32), ((colors - 0.5) / 0.2820948).astype(np.float32),
            np.zeros((n, 0, 3), np.float32)]


def render_capture(scene, viewmats: np.ndarray, focal: float, width: int, height: int,
                   background: float = 0.7, max_per_tile: int = 256, device="cpu") -> np.ndarray:
    """(V, H, W, 3) f32 images of `textured_scene` parameters rendered by the
    port from each world-to-camera matrix, principal point at the centre."""
    import torch

    from tpu_splat_torch.gs.render import render_view

    with torch.no_grad():
        params = [torch.from_numpy(a).to(device) for a in scene]
        bg = torch.full((3,), background, device=device)
        return np.stack([
            render_view(*params, torch.from_numpy(vm).to(device), focal, focal, width / 2,
                        height / 2, width, height, sh_degree=0, background=bg,
                        max_per_tile=max_per_tile, device=device).color.cpu().numpy()
            for vm in viewmats])


def centre_rmse(scene, viewmats: np.ndarray) -> float:
    """RMSE, in world units, of an SfMScene's registered camera centres
    against the true ones (world-to-camera `viewmats`, one per input image)
    after a similarity alignment."""
    reg = np.asarray(scene.registered)
    return camera_centre_rmse(np.asarray(scene.cameras.camtoworlds), np.asarray(viewmats)[reg])


def camera_centre_rmse(camtoworlds: np.ndarray, viewmats: np.ndarray) -> float:
    """RMSE, in world units, of camera-to-world poses' centres against the
    true ones (world-to-camera `viewmats`, one per pose) after a similarity
    alignment."""
    import torch

    from tpu_splat_torch.sfm.geometry import umeyama_alignment

    gt = np.stack([-vm[:3, :3].T @ vm[:3, 3] for vm in viewmats]).astype(np.float32)
    rec = np.asarray(camtoworlds)[:, :3, 3].astype(np.float32)
    s, R, t = umeyama_alignment(torch.from_numpy(rec), torch.from_numpy(gt))
    aligned = float(s) * rec @ R.numpy().T + t.numpy()
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))


def upright_viewmat(eye: np.ndarray, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """World-to-camera (4, 4) f32 for a camera at `eye` looking at `target`,
    with the image's down along world +y (no roll)."""
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.stack([x, np.cross(z, x), z])
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def _blobs(means: np.ndarray, colors: np.ndarray, rng: np.random.Generator,
           sizes: tuple) -> list:
    """Round opaque gaussians as render_view's parameter list, with sizes
    log-uniform in `sizes` (metres)."""
    n = len(means)
    log_s = rng.uniform(np.log(sizes[0]), np.log(sizes[1]), (n, 1))
    return [means.astype(np.float32), np.repeat(log_s, 3, 1).astype(np.float32),
            np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)),
            np.full((n,), 4.0, np.float32), ((colors - 0.5) / 0.2820948).astype(np.float32),
            np.zeros((n, 0, 3), np.float32)]


SUBJECT_BACKGROUND = 0.27  # subject_scene's sky: the ground's grey, no horizon


def subject_scene(rng: np.random.Generator, n_rock: int = 20_000,
                  n_ground: int = 30_000) -> tuple:
    """A capture subject for background removal: textured_scene's bumpy
    rock (blobs of 1-6 cm, uniform colours) on a dim blue-grey ground (+y
    down). Render it with a SUBJECT_BACKGROUND sky, so the only salient edge
    is the rock's. Returns (parameters, n_rock): the rock is the first n_rock
    gaussians."""
    dirs = rng.normal(size=(n_rock, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radius = (1.0 + 0.25 * np.sin(5 * dirs[:, 0]) * np.cos(4 * dirs[:, 1])
              + 0.05 * rng.normal(size=n_rock))
    ground = np.stack([rng.uniform(-4, 4, n_ground),
                       np.full(n_ground, 1.3) + rng.normal(0, 0.02, n_ground),
                       rng.uniform(-4, 4, n_ground)], axis=1)
    rock_rgb = rng.uniform(0, 1, (n_rock, 3))
    ground_rgb = (0.25 + rng.uniform(-0.08, 0.08, (n_ground, 1))
                  + np.array([[0.0, 0.03, 0.1]]))
    return _blobs(np.concatenate([dirs * radius[:, None], ground]),
                  np.concatenate([rock_rgb, ground_rgb]), rng, (0.01, 0.06)), n_rock


def arc_viewmats(n_views: int, radius: float = 3.2, height: float = -0.8,
                 arc: float = 2 * np.pi / 3) -> np.ndarray:
    """(n_views, 4, 4) upright cameras on a horizontal arc of `arc` radians
    around the origin, at y = height (above the ground when negative),
    looking at the origin."""
    return np.stack([upright_viewmat(np.array([radius * np.sin(a), height,
                                               -radius * np.cos(a)]))
                     for a in np.linspace(-arc / 2, arc / 2, n_views)])


def room_scene(rng: np.random.Generator, half: float = 4.0, n_wall: int = 80_000,
               n_flat: int = 20_000, sizes: tuple = (0.04, 0.2)) -> list:
    """A square room of textured blobs around the origin, for 360-degree
    captures: four walls at x, z = +-half from the ceiling (y = -2.5) to the
    floor (y = 1.3), and the floor and ceiling; uniform random colours.
    render_view's parameter list."""
    side = rng.integers(0, 4, n_wall)
    along = rng.uniform(-half, half, n_wall)
    walls = np.stack([np.where(side < 2, np.where(side == 0, -half, half), along),
                      rng.uniform(-2.5, 1.3, n_wall),
                      np.where(side < 2, along, np.where(side == 2, -half, half))], axis=1)
    walls += rng.normal(0, 0.02, walls.shape)
    flats = np.stack([rng.uniform(-half, half, 2 * n_flat),
                      np.repeat([1.3, -2.5], n_flat),
                      rng.uniform(-half, half, 2 * n_flat)], axis=1)
    means = np.concatenate([walls, flats])
    return _blobs(means, rng.uniform(0, 1, (len(means), 3)), rng, sizes)


def render_erp(scene, eyes: np.ndarray, height: int, face_size: int, background: float = 0.5,
               max_per_tile: int = 1024, device="cpu") -> np.ndarray:
    """(N, height, 2 * height, 3) f32 equirectangular frames of `scene` seen
    from each eye (no rotation: the frame's centre looks along +z): the six
    90-degree cube faces rendered by the port, then cubemap_to_erp."""
    import torch

    from tpu_splat_torch.gs.render import render_view
    from tpu_splat_torch.spherical.projections import _FACE_ROTS, FACE_NAMES, cubemap_to_erp

    f = c = (face_size - 1) / 2.0  # cubemap_to_erp's face camera; pixel i is at i
    out = []
    with torch.no_grad():
        params = [torch.from_numpy(a).to(device) for a in scene]
        bg = torch.full((3,), background, device=device)
        for eye in eyes:
            faces = []
            for name in FACE_NAMES:
                vm = np.eye(4, dtype=np.float32)
                vm[:3, :3] = _FACE_ROTS[name].T  # world -> face-local
                vm[:3, 3] = -_FACE_ROTS[name].T @ eye
                faces.append(render_view(*params, torch.from_numpy(vm).to(device), f, f, c, c,
                                         face_size, face_size, sh_degree=0, background=bg,
                                         max_per_tile=max_per_tile, device=device).color)
            out.append(cubemap_to_erp(torch.stack(faces), height, 2 * height).cpu().numpy())
    return np.stack(out)


def composite_scene(rng=None, n=6, h=120, w=160):
    """tests/test_matting_quality.py's matting capture: a bright textured
    ellipse sliding over a dark, low-texture background. Returns (images
    (N,H,W,3), gt_masks (N,H,W))."""
    rng = rng or np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    images = np.zeros((n, h, w, 3), np.float32)
    gt = np.zeros((n, h, w), np.float32)
    bg = 0.18 + 0.04 * np.sin(xx / 23.0) * np.cos(yy / 17.0)
    bg = np.stack([bg * 0.9, bg, bg * 1.1], axis=-1)
    for i in range(n):
        cx = w * (0.35 + 0.3 * i / max(n - 1, 1))
        cy = h * 0.5 + 6 * np.sin(i)
        d = ((xx - cx) / (0.22 * w)) ** 2 + ((yy - cy) / (0.3 * h)) ** 2
        m = (d < 1.0).astype(np.float32)
        tex = 0.75 + 0.2 * np.sin(xx / 5.0 + i) * np.sin(yy / 7.0)
        fg = np.stack([tex, 0.55 * tex, 0.35 * tex], axis=-1)
        img = bg * (1 - m[..., None]) + fg * m[..., None]
        img += 0.01 * rng.standard_normal(img.shape)
        images[i] = np.clip(img, 0, 1)
        gt[i] = m
    return images, gt


def mask_iou(pred: np.ndarray, gt: np.ndarray) -> float:
    """IoU of two masks thresholded at 0.5."""
    p = pred > 0.5
    g = gt > 0.5
    return float(np.logical_and(p, g).sum()) / max(float(np.logical_or(p, g).sum()), 1.0)


def seeded_u2net_state_dict(seed: int = 0, device="cpu") -> dict:
    """A full U2Net state dict from a seed, with the standard PyTorch keys: He-
    normal convolutions, each BatchNorm's running statistics set to its
    batch statistics on one seeded batch of two smooth 320x320 images, and
    the side and output
    convolutions scaled to unit-deviation logits on that batch. Every layer's
    output is then normalised, so the fused saliency spreads over [0, 1]
    (random weights alone saturate it)."""
    import torch
    import torch.nn.functional as F

    from tpu_splat_torch.matting.u2net import _MEAN, _STD, U2Net

    gen = torch.Generator().manual_seed(seed)
    net = U2Net("full")
    # smooth seeded images (8x8 colour fields, upsampled), preprocessed as
    # u2net_apply does: the statistics the net meets on a photograph
    x = F.interpolate(torch.rand((2, 3, 8, 8), generator=gen), size=(320, 320),
                      mode="bilinear", align_corners=False)
    x = (x / x.amax(dim=(1, 2, 3), keepdim=True) - torch.tensor(_MEAN)[:, None, None]) \
        / torch.tensor(_STD)[:, None, None]
    x = x.to(device)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                                 * (2.0 / fan_in) ** 0.5)
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=gen))
            elif isinstance(mod, torch.nn.BatchNorm2d):
                mod.momentum = None  # a cumulative average: one batch sets the statistics
        net.to(device).train()
        net(x)
        net.eval()
        heads = [getattr(net, f"side{i}") for i in range(1, 7)] + [net.outconv]
        for group in (heads[:6], heads[6:]):  # the sides first: they feed outconv
            spread = {}
            hooks = [m.register_forward_hook(
                lambda m, _, out: spread.__setitem__(m, float(out.std()))) for m in group]
            net(x)
            for h in hooks:
                h.remove()
            for m in group:
                m.weight /= spread[m]
                m.bias /= spread[m]
    return {k: v.cpu() for k, v in net.state_dict().items()}


def _host_tree(tree: dict, prefix: str = "") -> dict:
    """Tensors -> numpy (bf16 widened to f32), keys prefixed."""
    import torch

    return {prefix + k: (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
            for k, v in tree.items()}


def step_state(params: dict, adam, dstate) -> dict:
    """A training state (parameters, Adam moments, densify accumulators) as
    one flat dict of numpy arrays: "param means", "mu means", ...,
    "densify grad_accum"."""
    out = _host_tree(params, "param ")
    out.update(_host_tree(adam.mu, "mu "))
    out.update(_host_tree(adam.nu, "nu "))
    out.update(_host_tree(dstate._asdict(), "densify "))
    return out


def full_trainer_state(trainer) -> dict:
    """A DistributedTrainer's full state as numpy (a collective: every rank
    calls it)."""
    params, adam, dstate = trainer._full_state()
    out = step_state(params, adam, dstate)
    out.update({"count": adam.count.cpu().numpy(), "cam_deltas": trainer.cam_deltas.cpu().numpy(),
                "step": np.asarray(trainer.step)})
    return out


def mesh_checks(rank: int, device, log, setup: dict) -> dict:
    """One rank of the distributed checks that tests/test_torch_distributed.py
    and chip_smoke.py (phase 12) run through mesh.launch.spawn_ranks.

    setup: "mesh" (n_data, n_gauss); "params" (full numpy arrays);
    "scene_scale"; "batch", a dict of numpy images (B,H,W,3), viewmats,
    intrins, masks (B,H,W) and cam_deltas (B,6); "runs", a list of (name,
    TrainConfig, use_masks, n_steps): each run starts from the initial state
    and takes n_steps steps on the batch (step i with key i); optionally
    "trainer": {"cfg", "images", "viewmats", "intrins", "checkpoint_dir"}, a
    DistributedTrainer run through step 2 (where the config refines), a
    checkpoint at step 3, step 4, and a second trainer restored from the
    checkpoint that takes the same step 4. "full_from": the ranks that
    return full states (default all).

    Returns the rank's launch counts, shard row counts, and for each run its
    losses, seconds per step, peak memory and (on the "full_from" ranks) the
    full gathered state after the run."""
    import time

    import torch

    from tpu_splat_torch.gs import cuda_raster as cr
    from tpu_splat_torch.gs.optim import AdamState, adam_init
    from tpu_splat_torch.gs.strategy import DensifyState, densify_state_init
    from tpu_splat_torch.mesh.distributed import (make_distributed_train_step, make_mesh,
                                                  shard_params)
    from tpu_splat_torch.mesh.trainer import DistributedTrainer

    n_data, n_gauss = setup["mesh"]
    mesh = make_mesh(n_data, n_gauss, device=device)
    full_from = setup.get("full_from", range(n_data * n_gauss))
    b = setup["batch"]
    batch = {k: torch.as_tensor(b[k], dtype=torch.float32, device=device)
             for k in ("images", "viewmats", "masks", "cam_deltas")}
    h, w = b["images"].shape[1:3]
    cr.reset_launch_counts()
    out = {"rank": rank, "runs": {}}
    for name, cfg, use_masks, n_steps in setup["runs"]:
        params = shard_params(setup["params"], mesh)
        adam = adam_init(params)
        dstate = densify_state_init(params["means"].shape[0], device)
        out["shard_rows"] = {k: int(v.shape[0]) for k, v in params.items()}
        step_fn = make_distributed_train_step(mesh, cfg, w, h, cfg.sh_degree,
                                              setup["scene_scale"], use_masks=use_masks)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        run = {"loss": [], "cam_grads": []}
        t0 = time.time()
        for i in range(n_steps):
            params, adam, dstate, metrics, cam_grads = step_fn(
                params, adam, dstate, batch["images"], batch["viewmats"], b["intrins"],
                batch["masks"], batch["cam_deltas"], i, i)
            run["loss"].append(float(metrics["loss"]))  # waits for the step
            run["cam_grads"].append(cam_grads.cpu().numpy())
        run["s_per_step"] = (time.time() - t0) / n_steps
        run["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                           if device.type == "cuda" else None)
        def gather(tree):
            return {k: mesh.all_gather(v, "gauss") for k, v in tree.items()}

        full = (gather(params), AdamState(gather(adam.mu), gather(adam.nu), adam.count),
                DensifyState(**gather(dstate._asdict())))
        if rank in full_from:
            run["state"] = step_state(*full)
        out["runs"][name] = run
        del params, adam, dstate, full

    tr_setup = setup.get("trainer")
    if tr_setup:
        def trainer():
            return DistributedTrainer(setup["params"], tr_setup["images"], tr_setup["viewmats"],
                                      tr_setup["intrins"], setup["scene_scale"],
                                      tr_setup["cfg"], mesh=mesh, seed=0)

        first = trainer()
        first.checkpoint_dir = tr_setup["checkpoint_dir"]
        first.run(2)  # a refine and an opacity reset at step 2
        states = {"step 2": full_trainer_state(first)}
        first.run(1)  # the checkpoint at step 3
        states["step 3"] = full_trainer_state(first)
        first.run(1)
        states["step 4"] = full_trainer_state(first)
        second = trainer()
        second.load_checkpoint(tr_setup["checkpoint_dir"])
        states["restored"] = full_trainer_state(second)
        second.run(1)
        states["resumed"] = full_trainer_state(second)
        out["trainer"] = states
    out["launches"] = dict(cr.LAUNCHES)
    return out
