"""On-card smoke test of the PyTorch/CUDA port (tpu_splat_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU and the CUDA toolkit (nvcc); imports nothing of JAX or of
the JAX package. Phases, each of which raises on failure:

1. card: name and power limit, as nvidia-smi reports them;
2. build: compile the compositing kernels from tpu_splat_torch/csrc with nvcc;
3. kernels against their plain PyTorch versions, on the card: the
   check_kernel_parity fixture (near-empty, saturating and never-saturating
   tiles) and packed tensors from a real 1280x720 binning at K=256 and
   K=1024; forward and tstart max abs <= 2e-5 with the same chunks reached,
   counts-bounded sweep bit-identical, backward max|d| / max|g| <= 5e-5 fed
   by the plain forward's checkpoints and by the kernel's own; kernel and
   plain times;
4. full width: train_step on bench.py's workload (2^19 capacity, 400K alive,
   1280x720, SH degree 3, 8 ring views, no random background, K=256), ms/step
   from CUDA events after a warm-up, finite loss;
5. end to end: train_splat on a small seeded scene through one refine pass
   (the refine must change the gaussian count), then .ply/.spz written,
   reloaded and counted.

The launch counters are zeroed just before each of the two main paths
(phases 4 and 5) and read just after it; both kernels must have launched in
each. The line before the last is the {"kernels": [...]} record, with phase
4's launches; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from tpu_splat_torch.testing import build_packed, ring_viewmats, synthetic_capture

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per (pixel, gaussian) pair, counted from composite.cu:
# forward: offsets 2, sigma 9, exp/clamp/threshold 8, weight 1, rgb+depth
# accumulation 8, transmittance 2;
# backward: the same 17 to recompute alpha, e and dalpha 14, conic/mean
# chain 8, the 10 gradient terms 15, suffix 2, and 10 adds for the 256-pixel
# reduction of the 10 channels.
FWD_OPS_PER_PAIR = 30
BWD_OPS_PER_PAIR = 66
FWD_BAR, BWD_BAR = 2e-5, 5e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ring_views(n_views, width, height, rng, radius=4.5, fov_scale=0.85):
    """bench.py's camera ring: (viewmats, intrinsics, random images)."""
    intrins = np.tile(np.array([[width * fov_scale, width * fov_scale, width / 2, height / 2]],
                               np.float32), (n_views, 1))
    images = rng.uniform(0, 1, (n_views, height, width, 3)).astype(np.float32)
    return ring_viewmats(n_views, radius), intrins, images


def bench_params(rng, capacity, n_alive, device):
    """bench.py's 512K/400K-alive SH3 state, from the same seeded draws."""
    import torch

    alive = np.zeros(capacity, bool)
    alive[:n_alive] = True
    arrays = {
        "means": rng.uniform(-2, 2, (capacity, 3)),
        "scales": np.log(rng.uniform(0.005, 0.03, (capacity, 3))),
        "quats": np.concatenate([np.ones((capacity, 1)),
                                 0.1 * rng.normal(size=(capacity, 3))], 1),
        "opacities": rng.normal(0.0, 1.0, (capacity,)),
        "sh0": rng.normal(0, 0.5, (capacity, 3)),
        "shN": rng.normal(0, 0.05, (capacity, 15, 3)),
    }
    params = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in arrays.items()}
    params["alive"] = torch.from_numpy(alive).to(device)
    return params


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, packed, counts, tx, ty, rng, timing_reps=0):
    """Both kernels against their plain versions on one packed tensor.
    Returns a dict of errors, times and bounds."""
    import torch

    from tpu_splat_torch.gs import cuda_raster as cr

    t_total, k = packed.shape[1], packed.shape[2]
    n_chunks = k // cr.CHUNK
    out_k, ts_k = cr.composite_fwd_cuda(packed, counts, tx)
    out_p, ts_p = cr.composite_tiles_plain(packed, counts, tx, ty)
    full = torch.full_like(counts, k)
    out_full, _ = cr.composite_fwd_cuda(packed, full, tx)
    torch.cuda.synchronize()
    fwd_err = float((out_k[:, :5] - out_p[:, :5]).abs().max())
    ts_err = float((ts_k - ts_p).abs().max())
    if not fwd_err <= FWD_BAR:
        raise AssertionError(f"{name}: forward max abs {fwd_err:.3e} > {FWD_BAR}")
    # the backward skips every chunk whose checkpoint row is all zero
    reached_k = ts_k.reshape(t_total, n_chunks, cr.P).amax(dim=2) > 0
    reached_p = ts_p.reshape(t_total, n_chunks, cr.P).amax(dim=2) > 0
    if not torch.equal(reached_k, reached_p):
        raise AssertionError(f"{name}: the kernel reached {int(reached_k.sum())} chunks, "
                             f"the plain version {int(reached_p.sum())}")
    if not ts_err <= FWD_BAR:
        raise AssertionError(f"{name}: tstart max abs {ts_err:.3e} > {FWD_BAR}")
    if not torch.equal(out_k[:, :5], out_full[:, :5]):
        raise AssertionError(f"{name}: counts-bounded forward differs from the full sweep")
    if not torch.isfinite(out_k).all():
        raise AssertionError(f"{name}: non-finite forward output")

    gout = torch.from_numpy(rng.standard_normal((t_total, 8, cr.P)).astype(np.float32)).cuda()
    t_final = (1.0 - out_p[:, 3]).contiguous()
    g_p = cr.composite_tiles_bwd_plain(packed, gout, ts_p, t_final, tx)
    g_scale = float(g_p.abs().max()) + 1e-12
    # fed the plain forward's checkpoints, then the kernel's own (as training does)
    g_k = cr.composite_bwd_cuda(packed, gout, ts_p, t_final, tx)
    g_kk = cr.composite_bwd_cuda(packed, gout, ts_k, (1.0 - out_k[:, 3]).contiguous(), tx)
    torch.cuda.synchronize()
    bwd_abs = float((g_k - g_p).abs().max())
    bwd_rel = bwd_abs / g_scale
    chain_rel = float((g_kk - g_p).abs().max()) / g_scale
    for what, rel in (("backward", bwd_rel), ("backward from the kernel's tstart", chain_rel)):
        if not rel <= BWD_BAR:
            raise AssertionError(f"{name}: {what} max|d|/max|g| {rel:.3e} > {BWD_BAR}")
    log(f"[kernels] {name}: T={t_total} K={k} fwd max abs {fwd_err:.3e}, tstart "
        f"{ts_err:.3e} over {int(reached_k.sum())} reached chunks, counts-bounded "
        f"bit-identical, bwd max abs {bwd_abs:.3e} rel {bwd_rel:.3e} (from the kernel's "
        f"tstart: rel {chain_rel:.3e})")
    res = {"fwd_err": fwd_err, "bwd_abs": bwd_abs, "bwd_rel": bwd_rel}
    if not timing_reps:
        return res

    # data-dependent work: the chunks this input actually reaches
    reached = int(reached_p.sum())
    pairs = reached * cr.CHUNK * cr.P
    chunk_bytes = reached * cr.CHUNK * 10 * 4
    fwd_bytes = chunk_bytes + t_total * 4 + t_total * 8 * cr.P * 4 + t_total * n_chunks * cr.P * 4
    bwd_bytes = (chunk_bytes + t_total * 5 * cr.P * 4 + t_total * n_chunks * cr.P * 4
                 + t_total * cr.P * 4 + 16 * t_total * k * 4)

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    res["fwd_ms"] = time_ms(lambda: cr.composite_fwd_cuda(packed, counts, tx), timing_reps)
    res["bwd_ms"] = time_ms(lambda: cr.composite_bwd_cuda(packed, gout, ts_p, t_final, tx),
                            timing_reps)
    res["fwd_plain_ms"] = time_ms(lambda: cr.composite_tiles_plain(packed, counts, tx, ty), 3)
    res["bwd_plain_ms"] = time_ms(
        lambda: cr.composite_tiles_bwd_plain(packed, gout, ts_p, t_final, tx), 3)
    res["fwd_bound_ms"], res["fwd_bound_by"] = bound(fwd_bytes, pairs * FWD_OPS_PER_PAIR)
    res["bwd_bound_ms"], res["bwd_bound_by"] = bound(bwd_bytes, pairs * BWD_OPS_PER_PAIR)
    res["reached_chunks"] = reached
    log(f"[kernels] {name}: reached {reached}/{t_total * n_chunks} chunks; "
        f"fwd {res['fwd_ms']:.3f} ms (plain {res['fwd_plain_ms']:.3f}, bound "
        f"{res['fwd_bound_ms']:.4f} by {res['fwd_bound_by']}); bwd {res['bwd_ms']:.3f} ms "
        f"(plain {res['bwd_plain_ms']:.3f}, bound {res['bwd_bound_ms']:.4f} by "
        f"{res['bwd_bound_by']})")
    return res


def profile_steps(run_step, first: int, n: int, step_ms: float) -> None:
    """Device time by kernel over n steps (torch.profiler), per step, and the
    device's busy share of the unprofiled step time `step_ms` (the profiler's
    own host overhead stretches the wall-clock it sees)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + n):
            run_step(i)
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    log(f"[profile] {n} steps: device busy {busy_ms:.2f} ms/step = "
        f"{100 * busy_ms / step_ms:.1f}% of the {step_ms:.2f} ms step (idle "
        f"{100 * (1 - busy_ms / step_ms):.1f}%); {len(kernels)} kernel names; "
        f"{wall_ms:.1f} ms/step wall with the profiler on")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[profile] {e.self_device_time_total / 1e3 / n:8.3f} ms/step "
            f"{e.count / n:6.1f}x  {e.key[:90]}")


def layer_times(params, viewmat, intrin, image, width, height, k) -> dict:
    """ms of each layer of one training step, alone, at the main path's shapes
    (CUDA events over 10 calls after a warm-up)."""
    import torch

    from tpu_splat_torch.gs.losses import image_loss
    from tpu_splat_torch.gs.optim import adam_init, adam_update
    from tpu_splat_torch.gs.projection import project_gaussians
    from tpu_splat_torch.gs.rasterize import pack_tiles, tile_gaussians
    from tpu_splat_torch.gs.sh import sh_to_color

    trainable = {n: v.detach().requires_grad_(True) for n, v in params.items() if n != "alive"}
    op = torch.sigmoid(params["opacities"]).detach()

    def project_sh():
        proj = project_gaussians(trainable["means"], trainable["scales"], trainable["quats"],
                                 viewmat, *intrin, width, height, opacities=op)
        cam_pos = -viewmat[:3, :3].T @ viewmat[:3, 3]
        dirs = torch.nn.functional.normalize(trainable["means"] - cam_pos, dim=-1)
        col = sh_to_color(trainable["sh0"], trainable["shN"], dirs, 3)
        (proj.means2d.sum() + proj.conics.sum() + col.sum()).backward()
        return proj

    proj = project_sh()
    with torch.no_grad():
        cam_pos = -viewmat[:3, :3].T @ viewmat[:3, 3]
        dirs = torch.nn.functional.normalize(params["means"] - cam_pos, dim=-1)
        colors = sh_to_color(params["sh0"], params["shN"], dirs, 3)
        radii = torch.where(params["alive"], proj.radii, torch.zeros_like(proj.radii))
        args = [proj.means2d.detach(), proj.conics.detach(), colors, op, proj.depths.detach()]

    def pack():
        leaves = [a.clone().requires_grad_(True) for a in args]
        packed, _, _ = pack_tiles(*leaves, radii, width, height, 16, k)
        packed.backward(torch.ones_like(packed))

    pred = image.clone().flip(0).requires_grad_(True)
    grads = {n: torch.randn_like(v) for n, v in trainable.items()}
    adam = adam_init({n: v.detach() for n, v in trainable.items()})
    lrs = {n: 1e-3 for n in trainable}
    with torch.no_grad():
        detached = {n: v.detach() for n, v in trainable.items()}
    return {
        "project+sh fwd+bwd": time_ms(project_sh, 10),
        "binning (tile_gaussians)": time_ms(
            lambda: tile_gaussians(args[0], args[4], radii, width, height, 16, k, opacities=op),
            10),
        "binning+pack gather fwd+bwd": time_ms(pack, 10),
        "image_loss fwd+bwd": time_ms(lambda: image_loss(pred, image).backward(), 10),
        "adam_update": time_ms(lambda: adam_update(detached, grads, adam, lrs), 10),
    }


def real_packed(params, viewmat, intrin, width, height, k):
    """The packed tensor the main path hands the kernels for one view."""
    import torch

    from tpu_splat_torch.gs.projection import project_gaussians
    from tpu_splat_torch.gs.rasterize import pack_tiles
    from tpu_splat_torch.gs.sh import sh_to_color

    with torch.no_grad():
        op = torch.sigmoid(params["opacities"])
        proj = project_gaussians(params["means"], params["scales"], params["quats"], viewmat,
                                 *intrin, width, height, opacities=op)
        cam_pos = -viewmat[:3, :3].T @ viewmat[:3, 3]
        dirs = torch.nn.functional.normalize(params["means"] - cam_pos, dim=-1)
        colors = sh_to_color(params["sh0"], params["shN"], dirs, 3)
        radii = torch.where(params["alive"], proj.radii, torch.zeros_like(proj.radii))
        packed, counts, _ = pack_tiles(proj.means2d, proj.conics, colors, op, proj.depths,
                                       radii, width, height, 16, k)
    return packed.contiguous(), counts


def smoke_scene(device):
    """A seeded 16-view 320x180 capture of 3000 gaussians, rendered by the
    port, as an SfMScene and its images."""
    from tpu_splat_torch.core.types import Cameras, SfMScene

    vms, intrin, images, pts, colors = synthetic_capture(
        n=3000, width=320, height=180, focal=260.0, radius=3.2, seed=11, scale=0.04,
        max_per_tile=1024, device=device)
    n, (h, w) = len(pts), images.shape[1:3]
    cams = Cameras(camtoworlds=np.linalg.inv(vms).astype(np.float32),
                   fx=intrin[:, 0], fy=intrin[:, 1], cx=intrin[:, 2], cy=intrin[:, 3],
                   distortion=np.zeros((len(vms), 4), np.float32), width=w, height=h)
    scene = SfMScene(cameras=cams, points=pts, point_colors=colors,
                     point_errors=np.zeros(n, np.float32),
                     track_counts=np.full(n, 2, np.float32), registered=np.ones(len(vms), bool))
    return scene, images


def main_path_launches(path: str) -> dict:
    """The launch counts since the last reset; raises unless every kernel
    launched on this path."""
    from tpu_splat_torch.gs import cuda_raster as cr

    launches = dict(cr.LAUNCHES)
    log(f"[main path] {path}: launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {path} path")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tpu_splat_torch import kernel_build
    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.core.ply import load_ply, save_ply
    from tpu_splat_torch.core.spz import load_spz, save_spz
    from tpu_splat_torch.gs import cuda_raster as cr
    from tpu_splat_torch.gs.optim import adam_init
    from tpu_splat_torch.gs.pipeline import train_splat
    from tpu_splat_torch.gs.strategy import densify_state_init
    from tpu_splat_torch.gs.trainer import TrainConfig, train_step

    t_start = time.time()
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. card
    log(card_line())
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.time()
    lib_path, build_log = kernel_build.build("composite")
    log(f"[build] {os.path.relpath(lib_path, ROOT)} in {time.time() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"[build] {line.strip()}")

    # 3. kernels against their plain versions
    rng = np.random.default_rng(1)
    fx_packed, fx_counts = build_packed(rng, 12, 2 * cr.CHUNK, 4)
    compare("fixture", torch.from_numpy(fx_packed).to(dev), torch.from_numpy(fx_counts).to(dev),
            4, 3, rng)

    width, height, capacity, n_alive = 1280, 720, 1 << 19, 400_000
    tx, ty = math.ceil(width / 16), math.ceil(height / 16)
    brng = np.random.default_rng(0)
    params = bench_params(brng, capacity, n_alive, dev)
    vms, intrins, images = ring_views(8, width, height, brng)
    vms_d = torch.from_numpy(vms).to(dev)
    images_d = torch.from_numpy(images).to(dev)
    measured = {}
    for k in (256, 1024):
        packed, counts = real_packed(params, vms_d[0], [float(v) for v in intrins[0]],
                                     width, height, k)
        measured[k] = compare(f"1280x720 K={k}", packed, counts, tx, ty, rng, timing_reps=20)
        del packed, counts
    torch.cuda.empty_cache()

    # 4. full width: bench.py's train_step workload (K=256)
    cfg = TrainConfig(max_steps=30000, sh_degree=3, random_background=False)
    adam = adam_init(params)
    dstate = densify_state_init(capacity, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()

    def step(i, state):
        p, a, d = state
        v = i % 8
        p, a, d, m = train_step(p, a, d, images_d[v], vms_d[v], intrins[v], i, gen, 2.0,
                                cfg, width, height, 3)
        return (p, a, d), m

    state = (params, adam, dstate)
    cr.reset_launch_counts()
    for i in range(3):  # warm-up
        state, metrics = step(i, state)
    torch.cuda.synchronize()
    n_steps = 20
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for i in range(3, 3 + n_steps):
        state, metrics = step(i, state)
    ev1.record()
    torch.cuda.synchronize()
    step_ms = ev0.elapsed_time(ev1) / n_steps
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"full-width loss is not finite: {loss}")
    for name, v in state[0].items():
        if v.dtype.is_floating_point and not torch.isfinite(v).all():
            raise AssertionError(f"full-width parameter {name} is not finite")
    log(f"[full] 512K capacity / 400K alive, 1280x720, SH3, K=256: {step_ms:.2f} ms/step "
        f"over {n_steps} steps ({1000.0 / step_ms:.2f} it/s), final loss {loss:.5f}, "
        f"psnr {float(metrics['psnr']):.3f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_steps(lambda i: step(i, state), 3 + n_steps, 5, step_ms)
    launches_full = main_path_launches("full-width train_step")
    layers = layer_times(state[0], vms_d[0], [float(v) for v in intrins[0]], images_d[0],
                         width, height, cfg.max_per_tile)
    log("[layers] alone, ms: " + ", ".join(f"{n} {t:.3f}" for n, t in layers.items())
        + f"; kernels fwd {measured[256]['fwd_ms']:.3f} bwd {measured[256]['bwd_ms']:.3f}")
    del state, params, adam, dstate, images_d
    torch.cuda.empty_cache()

    # 5. end to end: train_splat through one refine pass, then export
    scene, imgs = smoke_scene(dev)
    _, metrics0 = train_splat(scene, imgs, max_steps=0, downscale_factor=1, sh_degree=3,
                              device=dev)
    cr.reset_launch_counts()
    t0 = time.time()
    cloud, metrics5 = train_splat(scene, imgs, max_steps=520, downscale_factor=1,
                                  sh_degree=3, seed=0, log_fn=lambda s: log(f"[e2e] {s}"),
                                  device=dev)
    torch.cuda.synchronize()
    e2e_s = time.time() - t0
    main_path_launches("train_splat")
    # the refine pass at step 500 must have changed the population
    if not (math.isfinite(metrics5["psnr"]) and cloud.num_points != scene.num_points):
        raise AssertionError(f"train_splat produced {cloud.num_points} gaussians from "
                             f"{scene.num_points}, held-out psnr {metrics5['psnr']}")
    os.makedirs(OUT_DIR, exist_ok=True)
    ply_path = os.path.join(OUT_DIR, "smoke.ply")
    spz_path = os.path.join(OUT_DIR, "smoke.spz")
    save_ply(cloud, ply_path)
    save_spz(cloud, spz_path)
    n_ply, n_spz = load_ply(ply_path).num_points, load_spz(spz_path).num_points
    if not n_ply == n_spz == cloud.num_points:
        raise AssertionError(f"export counts {n_ply}/{n_spz} != {cloud.num_points}")
    log(f"[e2e] train_splat 520 steps in {e2e_s:.1f} s: {scene.num_points} seed points -> "
        f"{cloud.num_points} gaussians, held-out psnr {metrics0['psnr']:.3f} -> "
        f"{metrics5['psnr']:.3f} "
        f"over {int(metrics5['eval_views'])} views; .ply/.spz reloaded with {n_ply} gaussians")

    m1024 = measured[1024]
    log("[kernels] K=1024 full-width: " + json.dumps({
        key: m1024[key] for key in ("fwd_ms", "fwd_plain_ms", "fwd_bound_ms", "bwd_ms",
                                    "bwd_plain_ms", "bwd_bound_ms")}))
    log(f"[done] {time.time() - t_start:.1f} s")

    m = measured[256]
    src = "tpu_splat_torch/csrc/composite.cu"
    kernels = [
        {"name": "composite_fwd", "route": "cuda", "source": src,
         "replaces": "tpu_splat/gs/pallas_raster.py:328",
         "launches": launches_full["composite_fwd"],
         "max_abs_err": m["fwd_err"], "ms": m["fwd_ms"], "plain_ms": m["fwd_plain_ms"],
         "bound_ms": m["fwd_bound_ms"], "bound_by": m["fwd_bound_by"], "library_ms": None},
        {"name": "composite_bwd", "route": "cuda", "source": src,
         "replaces": "tpu_splat/gs/pallas_raster.py:366",
         "launches": launches_full["composite_bwd"],
         "max_abs_err": m["bwd_abs"], "ms": m["bwd_ms"], "plain_ms": m["bwd_plain_ms"],
         "bound_ms": m["bwd_bound_ms"], "bound_by": m["bwd_bound_by"], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
