"""Sizes and opacities of a splat that the program's own training makes, for
the traffic mixes to draw from.

The capture scene of `tpu_splat_torch.core.meshrender` (a textured box and
three satellites on a ground slab inside four textured walls) is rendered on
the host from `--views` orbit views at `--width` x `--height` (focal 0.85 W,
the orbit of `meshrender.orbit_w2c`), a job's initial cloud is made from
`--points` points on its surfaces by the job's own initialisation
(`gs.params.init_params_from_points`, capacity 16x the points as
`gs.pipeline.train_splat` sizes it), and the program's `Trainer` trains it
under `TrainConfig.for_model(--model)`. At each of `--steps` it writes
`<out>/job-<W>x<H>.step<S>.csv`: `--rows` alive gaussians drawn at random,
each row its three log-scales in pixels at the orbit's radius (log of the
world scale times the focal over the radius) and its opacity logit. Beside
them `<out>/job_sizes.json` holds each snapshot's alive count and, over a
sample of views, the binning's footprint statistics (`footprints`), the
same statistics that `--scene <traffic> --seed <n>` reads off a traffic
mix's scene for comparison.

    python -m splatbench.tools.job_sizes --out build/sizes --steps 3500,10000,15000,20000 \
        --scene indoor-densify,outdoor-3m

It needs a CUDA card and runs for minutes; the benchmark's runs never call it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from multiprocessing import get_context

import numpy as np
import torch

from splatbench.reference import render as R

TILE = 16
ORBIT_RADIUS = 4.0  # meshrender.orbit_w2c's default


def _render_one(args):
    from tpu_splat_torch.core.meshrender import make_capture_scene, render_mesh

    w2c, f, w, h = args
    return render_mesh(make_capture_scene(), w2c, f, f, w / 2, h / 2, w, h)


def surface_points(n: int, seed: int):
    """n points uniform by area on the capture scene's triangles, coloured by
    the nearest texel of their face."""
    from tpu_splat_torch.core.meshrender import make_capture_scene

    mesh = make_capture_scene()
    rng = np.random.default_rng(seed)
    tri = mesh.verts[mesh.tris]                                   # (T, 3, 3)
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    t = rng.choice(len(tri), size=n, p=area / area.sum())
    u, v = rng.random(n), rng.random(n)
    flip = u + v > 1.0
    u, v = np.where(flip, 1.0 - u, u), np.where(flip, 1.0 - v, v)
    bary = np.stack([1.0 - u - v, u, v], axis=1)[:, :, None]
    pts = (tri[t] * bary).sum(1).astype(np.float32)
    uv = (mesh.uvs[t] * bary).sum(1)
    r = mesh.textures.shape[1]
    tex = mesh.textures[mesh.tex_ids[t],
                        np.clip((uv[:, 1] * r).astype(int), 0, r - 1),
                        np.clip((uv[:, 0] * r).astype(int), 0, r - 1)]
    return pts, np.clip(tex, 0.0, 1.0).astype(np.float32)


@torch.no_grad()
def footprints(params, viewmats, intrinsics, width: int, height: int, views) -> dict:
    """Over the given views, by the plain projection: the visible rows, the
    share of them that span more than 2x2 tiles ("big"), and how many bigs a
    view has beyond the binning's caps on full coverage (4096 or n/64 over
    4x4 tiles, 2048 or n/256 above), which are then drawn in their centre tile."""
    n = params["means"].shape[0]
    cap4, cap8 = min(max(n // 64, 4096), n), min(max(n // 256, 2048), n)
    op = torch.sigmoid(params["opacities"]) * params["alive"]
    vis, big, over = [], [], []
    for v in views:
        fx, fy, cx, cy = (float(x) for x in intrinsics[v])
        pr = R.project(params["means"], params["scales"], params["quats"], viewmats[v],
                       fx, fy, cx, cy, width, height, opacities=op)
        ok = pr.radii > 0
        mx, my, r = pr.means2d[:, 0], pr.means2d[:, 1], pr.radii
        tx, ty = math.ceil(width / TILE) - 1, math.ceil(height / TILE) - 1
        x0 = torch.clamp(torch.floor((mx - r) / TILE), 0, tx)
        x1 = torch.clamp(torch.floor((mx + r) / TILE), 0, tx)
        y0 = torch.clamp(torch.floor((my - r) / TILE), 0, ty)
        y1 = torch.clamp(torch.floor((my + r) / TILE), 0, ty)
        b = ok & ((x1 - x0 > 1) | (y1 - y0 > 1))
        b4 = b & (x1 - x0 <= 3) & (y1 - y0 <= 3)
        b8 = b & ~b4
        vis.append(int(ok.sum()))
        big.append(int(b.sum()))
        over.append(max(int(b4.sum()) - cap4, 0) + max(int(b8.sum()) - cap8, 0))
    return {"rows": n, "views": len(views), "visible_mean": float(np.mean(vis)),
            "big_share_of_visible": float(np.sum(big) / max(np.sum(vis), 1)),
            "big_mean": float(np.mean(big)), "over_caps_mean": float(np.mean(over)),
            "over_caps_share_of_big": float(np.sum(over) / max(np.sum(big), 1))}


def scene_footprints(traffic: str, seed: int, device) -> dict:
    from splatbench.scene import draw_cloud, ring_viewmats

    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "traffic",
                           f"{traffic}.json")) as f:
        tr = json.load(f)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cloud = draw_cloud(tr, gen, device)
    vm = torch.from_numpy(ring_viewmats(tr["views"], tr["ring_radius"],
                                        tr["ring_height"])).to(device)
    f = tr["focal_scale"] * tr["width"]
    intr = np.tile([[f, f, tr["width"] / 2, tr["height"] / 2]], (tr["views"], 1))
    views = range(0, tr["views"], max(tr["views"] // 8, 1))
    return dict(footprints(cloud, vm, intr, tr["width"], tr["height"], views),
                alive=int(cloud["alive"].sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", default="splatfacto")
    ap.add_argument("--views", type=int, default=96)
    ap.add_argument("--width", type=int, default=1557)
    ap.add_argument("--height", type=int, default=1038)
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--steps", default="3500,20000")
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget-s", type=float, default=1500.0,
                    help="stop before a snapshot that would end past this many seconds")
    ap.add_argument("--scene", default="", help="comma-separated traffic mixes to compare")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device(args.device)
    t_start = time.time()
    record = {"args": vars(args), "snapshots": [], "scenes": {}}
    path = os.path.join(args.out, "job_sizes.json")

    def save():
        with open(path, "w") as f:
            json.dump(record, f, indent=1)

    steps = [int(x) for x in args.steps.split(",") if x]
    if steps:
        train_job(args, steps, dev, record, save, t_start)
    for traffic in filter(None, args.scene.split(",")):
        record["scenes"][traffic] = scene_footprints(traffic, args.seed + 1, dev)
    save()
    print(json.dumps(record["scenes"]), flush=True)
    return 0


def train_job(args, steps, dev, record, save, t_start) -> None:
    from tpu_splat_torch.core.meshrender import orbit_w2c
    from tpu_splat_torch.gs.params import init_params_from_points
    from tpu_splat_torch.gs.trainer import Trainer, TrainConfig

    w, h, f = args.width, args.height, 0.85 * args.width
    angles = np.linspace(0, 2 * np.pi, args.views, endpoint=False)
    w2cs = np.stack([orbit_w2c(a) for a in angles]).astype(np.float32)
    with get_context("fork").Pool(min(os.cpu_count() or 1, 8)) as pool:
        images = np.stack(pool.map(_render_one, [(m, f, w, h) for m in w2cs]))
    record["render_s"] = time.time() - t_start
    pts, colors = surface_points(args.points, args.seed)
    capacity = 1 << int(math.ceil(math.log2(max(len(pts) * 16, 4096))))
    params = init_params_from_points(pts, colors, capacity=capacity, device=dev)
    scene_scale = float(np.mean(np.linalg.norm(pts - pts.mean(0), axis=1))) * 1.1
    intr = np.tile(np.array([[f, f, w / 2, h / 2]], np.float32), (args.views, 1))
    cfg = TrainConfig.for_model(args.model)
    trainer = Trainer(params, images, w2cs, intr, scene_scale, cfg, seed=args.seed, device=dev)
    record.update(capacity=capacity, scene_scale=scene_scale, init_s=time.time() - t_start)
    save()
    vm = torch.as_tensor(w2cs, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    last = time.time()
    for target in steps:
        rate = max(trainer.step, 1) / max(last - record["init_s"] - t_start, 1e-9)
        if time.time() - t_start + (target - trainer.step) / max(rate, 1e-9) > args.budget_s \
                and trainer.step > 0:
            record["stopped_before"] = target
            break
        trainer.run(target - trainer.step)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        last = time.time()
        p = trainer.params
        alive = p["alive"]
        idx = torch.nonzero(alive).squeeze(1)
        pick = idx[torch.randint(len(idx), (args.rows,), generator=gen, device=dev)]
        ls = p["scales"][pick] + math.log(f / ORBIT_RADIUS)
        rows = torch.cat([ls, p["opacities"][pick, None]], dim=1).cpu().numpy()
        name = f"job-{w}x{h}.step{target}.csv"
        np.savetxt(os.path.join(args.out, name), rows, fmt="%.5f", delimiter=",",
                   header="log_scale_px_0,log_scale_px_1,log_scale_px_2,opacity_logit",
                   comments="")
        views = range(0, args.views, max(args.views // 8, 1))
        record["snapshots"].append({
            "step": target, "alive": int(alive.sum()), "capacity": int(alive.shape[0]),
            "file": name, "seconds": last - t_start,
            "footprints": footprints(p, vm, intr, w, h, views)})
        save()
        print(json.dumps(record["snapshots"][-1]), flush=True)
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()


if __name__ == "__main__":
    raise SystemExit(main())
