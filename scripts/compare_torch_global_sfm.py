"""Global SfM (a job with softwareName glomap) on chip_smoke.py phase 11's
capture: phase 6's 16 frames of 1280x720 of testing.textured_scene on the
forward walk, as the 8-bit PNGs of phase 7's .zip. Prints each outcome:
registered frames, camera-centre RMSE after a similarity alignment (world
units, and as a fraction of the walk's span), sparse points, final BA rms,
seconds.

    python scripts/compare_torch_global_sfm.py --render [--device cuda]

renders the capture with the port (on the card, as chip_smoke.py does) and
writes build/global_sfm/capture.zip;

    JAX_PLATFORMS=cpu python scripts/compare_torch_global_sfm.py --record

runs the JAX package's run_job on that .zip (glomap, training off: the SfM
half of phase 11's job) on the CPU, and prints the record phase 11 holds the
port to (chip_smoke.GLOBAL_SFM_REFERENCE), with the capture's statistics;

    python scripts/compare_torch_global_sfm.py --package port [--device cuda]

runs the same job through the port.
"""

import argparse
import json
import os
import sys
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ZIP = os.path.join(ROOT, "build", "global_sfm", "capture.zip")


def run(package: str, zip_path: str, device: str) -> dict:
    """One glomap job without training through `package`'s run_job; its
    outcome."""
    import re
    import shutil

    import chip_smoke as cs
    from tpu_splat_torch.sfm.colmap_io import count_points3d
    from tpu_splat_torch.testing import walk_viewmats

    if package == "reference":
        from tpu_splat.core.config import job_config_from_json
        from tpu_splat.pipeline.runner import run_job
        kw = {}
    else:
        from tpu_splat_torch.core.config import job_config_from_json
        from tpu_splat_torch.pipeline.runner import run_job
        kw = {"device": device}
    out = os.path.join(ROOT, "build", "global_sfm", package)
    shutil.rmtree(out, ignore_errors=True)
    cfg = job_config_from_json({"uuid": f"global-{package}", "inputPath": zip_path,
                                "outputPath": out, "sfm": {"softwareName": "glomap"},
                                "training": {"enable": False}})
    lines = []
    t0 = time.time()
    res = run_job(cfg, log_fn=lines.append, **kw)
    seconds = time.time() - t0
    poses = cs.model_poses(out)
    ba = [s for s in lines if s.startswith("BA:")]
    return {"registered": int(res.metrics["num_registered"]),
            "points": count_points3d(os.path.join(out, "colmap", "sparse", "0")),
            "rmse": cs.model_rmse(poses, walk_viewmats(16)),
            "final_rms_px": float(re.search(r"rms ([0-9.]+)px", ba[-1])[1]) if ba else None,
            "seconds": seconds, "sfm_s": res.timings["SfM"],
            "log": [s for s in lines if s.startswith(("global:", "BA:", "sfm timers",
                                                      "matching", "focal"))]}


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
        _, images = cs.sfm_capture(16, 1280, 720, cs.SFM_FOCAL, args.device)
        os.makedirs(os.path.dirname(args.zip), exist_ok=True)
        cs.zip_frames(images, args.zip)
        mean, values = cs.capture_stats(images)
        print(f"wrote {args.zip}: mean {mean!r}, values {values!r}")
        return
    import torch

    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    from tpu_splat_torch.ingest.video import extract_zip, load_images_from_dir

    tmp = os.path.join(ROOT, "build", "global_sfm", "frames")
    extract_zip(args.zip, tmp)
    frames, _ = load_images_from_dir(tmp)
    mean, values = cs.capture_stats(frames)
    package = "reference" if args.record else args.package
    out = run(package, args.zip, args.device)
    span = cs.WALK_SPAN
    print(f"{package}: registered {out['registered']}/16, {out['points']} points, "
          f"camera-centre RMSE {out['rmse']:.5f} ({out['rmse'] / span:.5f} of the span), "
          f"final BA rms {out['final_rms_px']} px, job {out['seconds']:.1f} s "
          f"(SfM {out['sfm_s']:.1f} s)")
    for line in out["log"]:
        print("  " + line)
    if args.record:
        record = {k: out[k] for k in ("registered", "points", "rmse", "final_rms_px")}
        record.update(capture_mean=mean, capture_values=values)
        print("GLOBAL_SFM_REFERENCE = " + json.dumps(record))


if __name__ == "__main__":
    main()
