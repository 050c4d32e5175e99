"""The --spherical job on chip_smoke.py phase 9's capture: testing.room_scene
seen from 4 eyes on an arc, as 512x1024 equirectangular frames stitched from
cube faces the port rendered, the 8-bit PNGs of phase 9's .zip. The job is
the generator's `--spherical --preset fast` with cubeFacesToRemove
"up,down" (64 views of 256x256, sequential matching). Prints each outcome:
views handed to SfM, registered views (and which), the camera-centre RMSE
of the registered views against their frames' true eyes after a similarity
alignment (world units, and as a fraction of the eyes' span), sparse
points, final BA rms, seconds.

    python scripts/compare_torch_spherical_sfm.py --render [--device cuda] [--zip PATH]

renders the capture with the port (on the card, as chip_smoke.py does) and
writes build/spherical_sfm/capture.zip (or PATH);

    JAX_PLATFORMS=cpu python scripts/compare_torch_spherical_sfm.py --record

runs the JAX package's run_job on that .zip (training off: the SfM half of
phase 9's job) on the CPU, and prints the record phase 9 holds the port to
(chip_smoke.SPHERICAL_REFERENCE), with the capture's statistics;

    python scripts/compare_torch_spherical_sfm.py --package port [--device cuda]

runs the same job through the port.
"""

import argparse
import json
import os
import sys
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ZIP = os.path.join(ROOT, "build", "spherical_sfm", "capture.zip")


def run(package: str, zip_path: str, device: str) -> dict:
    """Phase 9's job without training through `package`'s generator and
    run_job; its outcome."""
    import re
    import shutil

    import chip_smoke as cs
    from tpu_splat_torch.sfm.colmap_io import count_points3d

    if package == "reference":
        from tpu_splat.cli.generate_splat import build_job_json
        from tpu_splat.core.config import job_config_from_json
        from tpu_splat.pipeline.runner import run_job
        kw = {}
    else:
        from tpu_splat_torch.cli.generate_splat import build_job_json
        from tpu_splat_torch.core.config import job_config_from_json
        from tpu_splat_torch.pipeline.runner import run_job
        kw = {"device": device}
    out = os.path.join(ROOT, "build", "spherical_sfm", package)
    shutil.rmtree(out, ignore_errors=True)
    job = build_job_json(zip_path, out, "fast", spherical=True,
                         job_uuid=f"spherical-{package}")
    for section, values in cs.spherical_job_edits(0).items():
        job[section].update(values)
    lines = []
    t0 = time.time()
    res = run_job(job_config_from_json(job), log_fn=lines.append, **kw)
    seconds = time.time() - t0
    ba = [s for s in lines if s.startswith("BA:")]
    poses = cs.model_poses(out)
    return {"num_images": int(res.metrics["num_images"]),
            "registered": int(res.metrics["num_registered"]),
            "registered_views": sorted(poses), "rmse": cs.spherical_rmse(poses),
            "points": count_points3d(os.path.join(out, "colmap", "sparse", "0")),
            "final_rms_px": float(re.search(r"rms ([0-9.]+)px", ba[-1])[1]) if ba else None,
            "seconds": seconds, "sfm_s": res.timings["SfM"],
            "log": [s for s in lines if s.startswith(("BA:", "sfm timers", "matching",
                                                      "focal", "registered"))]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--render", action="store_true", help="render the capture and zip it")
    ap.add_argument("--record", action="store_true",
                    help="print chip_smoke.py's record of the reference's outcome")
    ap.add_argument("--package", choices=["port", "reference"], default="reference")
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--zip", default=ZIP)
    args = ap.parse_args()

    import chip_smoke as cs

    if args.render:
        _, erps = cs.spherical_capture(args.device)
        os.makedirs(os.path.dirname(os.path.abspath(args.zip)), exist_ok=True)
        cs.zip_frames(erps, args.zip)
        mean, values = cs.capture_stats(erps, cs.ERP_PIXELS)
        print(f"wrote {args.zip}: mean {mean!r}, values {values!r}")
        return
    import torch

    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    from tpu_splat_torch.ingest.video import extract_zip, load_images_from_dir

    tmp = os.path.join(os.path.dirname(os.path.abspath(args.zip)), "frames")
    extract_zip(args.zip, tmp)
    frames, _ = load_images_from_dir(tmp)
    mean, values = cs.capture_stats(frames, cs.ERP_PIXELS)
    package = "reference" if args.record else args.package
    out = run(package, args.zip, args.device)
    print(f"{package}: registered {out['registered']}/{out['num_images']} views "
          f"{out['registered_views']}, camera-centre RMSE {out['rmse']:.5f} "
          f"({out['rmse'] / cs.spherical_eye_span():.5f} of the eyes' span), "
          f"{out['points']} points, final BA rms "
          f"{out['final_rms_px']} px, job {out['seconds']:.1f} s (SfM {out['sfm_s']:.1f} s); "
          f"capture mean {mean!r}, values {values!r}")
    for line in out["log"]:
        print("  " + line)
    if args.record:
        record = {k: out[k] for k in ("num_images", "registered", "rmse")}
        record.update(capture_mean=mean, capture_values=values)
        print("SPHERICAL_REFERENCE = " + json.dumps(record))


if __name__ == "__main__":
    main()
