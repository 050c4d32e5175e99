"""The multi-video property scan (a comma-separated list of videos merged into
one SfM) on chip_smoke.py phase 15's capture: core/meshrender's capture scene
on one orbit at 384x288, as two overlapping mp4v videos (frames [:13] and
[9:] of 22; tests/test_spherical_multivideo_e2e.py's shape). Prints each
outcome: frames extracted per video, registered frames in all and per
video, camera-centre RMSE after a similarity alignment (world units, and as
a fraction of the orbit's diameter), sparse points, final BA rms, seconds.

    python scripts/compare_torch_multivideo.py --render [--dir DIR]

renders the capture with the port (host numpy) and writes the two videos
to build/multivideo/ (or DIR);

    JAX_PLATFORMS=cpu python scripts/compare_torch_multivideo.py --record --seeds 0-4

runs the JAX package's run_job on those videos (training off: the SfM half
of phase 15's job) on the CPU, once for each of the mapper's RANSAC seeds
(about 10 minutes a seed; run seeds as separate processes to overlap
them; the job itself runs with seed 0), and prints the record phase 15
holds the port to (chip_smoke.MULTIVIDEO_REFERENCE), from the first seed,
with the decoded capture's statistics;

    python scripts/compare_torch_multivideo.py --package port [--device cuda] [--seeds 0-4]

runs the same job through the port.
"""

import argparse
import json
import os
import sys
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DIR = os.path.join(ROOT, "build", "multivideo")


def run(package: str, paths, device: str, seed: int = 0) -> dict:
    """One multi-video job without training through `package`'s run_job,
    its mapper's RANSAC seeded with `seed`; its outcome and the frames it
    decoded."""
    import dataclasses
    import re
    import shutil

    import chip_smoke as cs
    from tpu_splat_torch.sfm.colmap_io import count_points3d

    if package == "reference":
        from tpu_splat.core.config import job_config_from_json
        from tpu_splat.pipeline import runner
        from tpu_splat.sfm import mapper
        kw = {}
    else:
        from tpu_splat_torch.core.config import job_config_from_json
        from tpu_splat_torch.pipeline import runner
        from tpu_splat_torch.sfm import mapper
        kw = {"device": device}
    run_sfm = mapper.run_sfm

    def seeded(images, cfg, **sfm_kw):
        return run_sfm(images, dataclasses.replace(cfg, seed=seed), **sfm_kw)
    out = os.path.join(ROOT, "build", "multivideo", f"{package}_seed{seed}")
    shutil.rmtree(out, ignore_errors=True)
    cfg = job_config_from_json(cs.multivideo_job(paths, f"multivideo-{package}", out, 0))
    lines = []
    t0 = time.time()
    mapper.run_sfm = seeded
    try:
        with cs.decoded_media(runner) as seen:
            res = runner.run_job(cfg, log_fn=lines.append, **kw)
    finally:
        mapper.run_sfm = run_sfm
    seconds = time.time() - t0
    poses = cs.model_poses(out)
    ba = [s for s in lines if s.startswith("BA:")]
    return {"num_images": int(res.metrics["num_images"]), "segments": seen["segments"],
            "registered": int(res.metrics["num_registered"]),
            "registered_per_video": cs.registered_per_segment(poses, seen["segments"]),
            "points": count_points3d(os.path.join(out, "colmap", "sparse", "0")),
            "rmse": cs.model_rmse(poses, cs.multivideo_viewmats()),
            "final_rms_px": float(re.search(r"rms ([0-9.]+)px", ba[-1])[1]) if ba else None,
            "seconds": seconds, "sfm_s": res.timings["SfM"], "images": seen["images"],
            "log": lines}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--render", action="store_true", help="render the capture as two videos")
    ap.add_argument("--record", action="store_true",
                    help="print chip_smoke.py's record of the reference's outcome")
    ap.add_argument("--package", choices=["port", "reference"], default="reference")
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--dir", default=DIR, help="where the two videos are")
    ap.add_argument("--seeds", default="0", help="mapper RANSAC seeds, e.g. 0-4 or 0,3")
    args = ap.parse_args()
    lo, _, hi = args.seeds.partition("-")
    args.seeds = (list(range(int(lo), int(hi) + 1)) if hi
                  else [int(v) for v in args.seeds.split(",")])

    import chip_smoke as cs

    if args.render:
        t0 = time.time()
        paths = cs.multivideo_capture(args.dir)
        print(f"wrote {paths} in {time.time() - t0:.1f} s")
        return
    import torch

    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    paths = [os.path.join(args.dir, name) for name, _ in cs.MULTIVIDEO_SEGMENTS]
    package = "reference" if args.record else args.package
    outs = {}
    for seed in args.seeds:
        out = outs[seed] = run(package, paths, args.device, seed)
        mean, values = cs.capture_stats(out["images"], cs.MULTIVIDEO_PIXELS)
        print(f"{package}, RANSAC seed {seed}: {out['num_images']} frames (per video "
              f"{out['segments']}), registered {out['registered']} (per video "
              f"{out['registered_per_video']}), {out['points']} points, camera-centre RMSE "
              f"{out['rmse']:.5f} ({out['rmse'] / cs.ORBIT_DIAMETER:.5f} of the orbit's "
              f"diameter), final BA rms {out['final_rms_px']} px, job {out['seconds']:.1f} s "
              f"(SfM {out['sfm_s']:.1f} s); capture mean {mean!r}, values {values!r}",
              flush=True)
        for line in out["log"]:
            if line.startswith(("BA:", "sfm timers", "matching", "focal")):
                print("  " + line)
    if args.record:
        # the first seed's outcome (a job runs with seed 0); the others show
        # whether it holds under other RANSAC draws
        both = [s for s in args.seeds if min(outs[s]["registered_per_video"]) > 0]
        print(f"frames of both videos registered under seeds {both} of {args.seeds}")
        record = {k: outs[args.seeds[0]][k] for k in ("segments", "registered", "rmse")}
        record.update(capture_mean=mean, capture_values=values)
        print("MULTIVIDEO_REFERENCE = " + json.dumps(record))


if __name__ == "__main__":
    main()
