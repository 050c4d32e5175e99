"""Run SfM at chip_smoke.py's phase-6 configuration (16 frames of 1280x720 on
a forward walk, 4096 features, 4 octaves, sequential matching, no focal
given) on variants of its textured scene, in the PyTorch port or in the JAX
package, and print each outcome: registered frames, points, recovered focal,
final BA rms and camera-centre RMSE as a fraction of the walk's span.

    # render the variants with the port and keep them as 8-bit frames
    python scripts/compare_torch_sfm_scenes.py render --variants A,D,F --device cpu
    # the JAX package's run_sfm on those frames, on the CPU
    JAX_PLATFORMS=cpu python scripts/compare_torch_sfm_scenes.py run --package reference \\
        --variants A --source frames
    # the port's run_sfm on the same frames, and on its own f32 render, on the card
    python scripts/compare_torch_sfm_scenes.py run --package port --variants A,D,E,F,G \\
        --source frames,render

Both packages read the same 8-bit frames (value / 255), so a difference in
outcome there is the packages', not the render's; `--seeds` repeats a run
under other RANSAC draws, to show how far the draws alone move it. `--source render` is the
phase-6 path: the port renders f32 frames on the device and maps them.
Frames go to build/sfm_scenes/, and the mapper logs too unless --log-dir
says otherwise.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "sfm_scenes")

N_VIEWS, WIDTH, HEIGHT, FOCAL, SPAN = 16, 1280, 720, 1100.0, 5.0

# name -> (description, textured_scene keyword arguments)
VARIANTS = {
    "A": ("100K blobs of 5 cm, bimodal colour", dict(sizes=(0.05, 0.05), bimodal=True)),
    "D": ("100K blobs of 7 cm, bimodal colour", dict(sizes=(0.07, 0.07), bimodal=True)),
    "E": ("100K blobs of 1-6 cm, uniform colour (phase 6)", {}),
    "F": ("48K blobs of 2-10 cm, uniform colour",
          dict(n_rock=9_600, n_plane=19_200, n_wall=19_200, sizes=(0.02, 0.1))),
    "G": ("100K blobs of 1-6 cm, bimodal colour", dict(bimodal=True)),
}


def render(name, device):
    from tpu_splat_torch.testing import render_capture, textured_scene, walk_viewmats

    vms = walk_viewmats(N_VIEWS)
    scene = textured_scene(np.random.default_rng(3), **VARIANTS[name][1])
    return vms, render_capture(scene, vms, FOCAL, WIDTH, HEIGHT, max_per_tile=1024,
                               device=device)


def run_sfm(package, images, device, log_fn, seed):
    if package == "port":
        from tpu_splat_torch.sfm.features import FeatureConfig
        from tpu_splat_torch.sfm.mapper import MapperConfig, run_sfm
        kw = dict(device=device)
    else:
        from tpu_splat.sfm.features import FeatureConfig
        from tpu_splat.sfm.mapper import MapperConfig, run_sfm
        kw = {}
    cfg = MapperConfig(feature=FeatureConfig(max_features=4096, num_octaves=4,
                                             upsample_first=False),
                       matching_method="sequential", seed=seed)
    return run_sfm(images, cfg, log_fn=log_fn, **kw)


def outcome(scene, vms, logs):
    from tpu_splat_torch.testing import centre_rmse

    reg = np.asarray(scene.registered)
    ba = [s for s in logs if s.startswith("BA:")]
    finite = bool(np.isfinite(np.asarray(scene.cameras.camtoworlds)).all()
                  and np.isfinite(np.asarray(scene.points)).all())
    return {"registered": int(reg.sum()), "points": int(scene.num_points),
            "fx": float(np.asarray(scene.cameras.fx)[0]),
            "final_ba": ba[-1] if ba else None, "finite": finite,
            "rmse_of_span": centre_rmse(scene, vms) / SPAN if reg.sum() >= 3 else None,
            "pairs": [s for s in logs if s.startswith("matching:")]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=["render", "run"])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--package", choices=["port", "reference"], default="port")
    ap.add_argument("--source", default="frames",
                    help="comma list of 'frames' (the saved 8-bit frames) and 'render' "
                         "(the port's f32 render on --device)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", default="0",
                    help="comma list of mapper seeds (MapperConfig.seed: the RANSAC draws)")
    ap.add_argument("--log-dir", default=OUT, help="where the mapper logs go")
    args = ap.parse_args()
    os.makedirs(args.log_dir, exist_ok=True)
    os.makedirs(OUT, exist_ok=True)
    card = ""
    if args.device == "cuda":
        import subprocess
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        print(card, flush=True)
    for name in args.variants.split(","):
        path = os.path.join(OUT, f"{name}.npz")
        if args.command == "render":
            t0 = time.time()
            vms, images = render(name, args.device)
            frames = np.round(np.clip(images, 0, 1) * 255).astype(np.uint8)
            np.savez(path, frames=frames, viewmats=vms)
            print(f"{name}: rendered {VARIANTS[name][0]} in {time.time() - t0:.1f} s -> {path}",
                  flush=True)
            continue
        for source in args.source.split(","):
            if source == "frames":
                data = np.load(path)
                vms, images = data["viewmats"], data["frames"].astype(np.float32) / 255
            else:
                vms, images = render(name, args.device)
            for seed in map(int, args.seeds.split(",")):
                logs = []
                t0 = time.time()
                scene = run_sfm(args.package, images, args.device, logs.append, seed)
                seconds = time.time() - t0
                tag = f"{name}_{args.package}_{source}_{args.device}_seed{seed}"
                with open(os.path.join(args.log_dir, f"{tag}.log"), "w") as f:
                    f.write("\n".join(logs) + "\n")
                rec = {"variant": name, "scene": VARIANTS[name][0], "package": args.package,
                       "source": source, "device": args.device, "seed": seed, "card": card,
                       "seconds": seconds, **outcome(scene, vms, logs)}
                print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
