"""Run the self-calibrated slice of tests/test_torch_sfm_mapper.py (both
packages' run_sfm, no intrinsics, on tests/test_sfm_e2e.py's forward walk)
at other view counts, and print each outcome: registered views, points,
recovered focal, camera-centre RMSE as a fraction of the walk's span, final
BA rms and seconds.

    JAX_PLATFORMS=cpu python scripts/compare_torch_sfm_walk.py --views 7,8,9,10 \\
        --package reference

The test maps the fewest views on which the reference meets the 4% bar of
tests/test_sfm_e2e.py's self-calibrated walk test; this shows where that is.

    JAX_PLATFORMS=cpu python scripts/compare_torch_sfm_walk.py --record

runs the reference on the test's own capture (its view count) and prints the
constants the test holds the port against: the reference's outcome and the
capture's statistics (its mean and the pixels at CAPTURE_PIXELS).
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", default="7,8,9,10")
    ap.add_argument("--package", choices=["port", "reference"], default="reference")
    ap.add_argument("--record", action="store_true",
                    help="print the test's record of the reference's outcome")
    ap.add_argument("--repeat", type=int, default=1,
                    help="map each capture this many times in one process (the "
                         "reference's first run compiles its XLA programs, the next "
                         "ones reuse them)")
    args = ap.parse_args()

    import torch

    from test_sfm_e2e import FX, H, W, _walk_cfg, make_textured_scene, walk_cameras
    from test_torch_sfm_mapper import (CAPTURE_PIXELS, N_VIEWS, SPAN, events, final_rms_px,
                                       port_cfg)
    from tpu_splat_torch.testing import centre_rmse, render_capture

    torch.set_num_threads(1)
    cloud = make_textured_scene(np.random.default_rng(9))
    scene = [np.asarray(a) for a in (cloud.means, cloud.scales, cloud.quats, cloud.opacities,
                                     cloud.sh0, cloud.shN)]
    if args.record:
        args.views, args.package = str(N_VIEWS), "reference"
    for n in map(int, args.views.split(",")):
        viewmats = walk_cameras(n_views=n)
        images = render_capture(scene, viewmats, FX, W, H)
        for run in range(args.repeat):
            logs = []
            t0 = time.time()
            if args.package == "reference":
                from tpu_splat.sfm import mapper
                out = mapper.run_sfm(images, _walk_cfg(), log_fn=logs.append)
            else:
                from tpu_splat_torch.sfm import mapper
                out = mapper.run_sfm(images, port_cfg(_walk_cfg()), log_fn=logs.append,
                                     device="cpu")
            print(f"run {run + 1}: {args.package} {n} views: registered "
                  f"{int(np.asarray(out.registered).sum())}, points {out.num_points}, fx "
                  f"{float(np.asarray(out.cameras.fx)[0]):.1f} (true {FX}), camera-centre "
                  f"RMSE {centre_rmse(out, viewmats) / SPAN:.4f} of the span, final rms "
                  f"{final_rms_px(logs)} px, {time.time() - t0:.1f} s", flush=True)
        if args.record:
            record = dict(registered=int(np.asarray(out.registered).sum()),
                          points=int(out.num_points), fx=float(np.asarray(out.cameras.fx)[0]),
                          rmse=float(centre_rmse(out, viewmats)),
                          final_rms_px=final_rms_px(logs), events=sorted(events(logs)))
            print(f"REFERENCE = {record!r}")
            print(f"CAPTURE_MEAN = {float(images.mean())!r}")
            print("CAPTURE_VALUES = " + repr([round(float(images[p]), 6)
                                              for p in CAPTURE_PIXELS]))


if __name__ == "__main__":
    main()
