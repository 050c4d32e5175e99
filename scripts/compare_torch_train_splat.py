"""Run train_splat in the JAX package and in its PyTorch port on the same
seeded 16-view capture (64x48, 60 ground-truth gaussians, two views held out),
on the CPU, and print both results side by side.

    JAX_PLATFORMS=cpu python scripts/compare_torch_train_splat.py --steps 600 --seed 0

The two runs draw their random backgrounds from different generators, so they
agree in distribution, not bit for bit. Use it to check the port over more
steps than the CPU tests can afford (600 steps pass the first refine at 500).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax.numpy as jnp
    import torch

    from tpu_splat.core import types as jtypes
    from tpu_splat.gs import pipeline as jpipe
    from tpu_splat_torch.core import types as ttypes
    from tpu_splat_torch.gs import pipeline as tpipe
    from tpu_splat_torch.testing import synthetic_capture

    viewmats, intrin, images, pts, colors = synthetic_capture()
    c2w = np.linalg.inv(viewmats).astype(np.float32)
    m, h, w = images.shape[:3]
    jscene = jtypes.SfMScene(
        cameras=jtypes.Cameras(camtoworlds=jnp.asarray(c2w), fx=jnp.asarray(intrin[:, 0]),
                               fy=jnp.asarray(intrin[:, 1]), cx=jnp.asarray(intrin[:, 2]),
                               cy=jnp.asarray(intrin[:, 3]), distortion=jnp.zeros((m, 4)),
                               width=w, height=h),
        points=jnp.asarray(pts), point_colors=jnp.asarray(colors),
        point_errors=jnp.zeros(len(pts)), track_counts=jnp.ones(len(pts)),
        registered=jnp.ones(m, bool))
    tscene = ttypes.SfMScene(
        cameras=ttypes.Cameras(camtoworlds=c2w, fx=intrin[:, 0], fy=intrin[:, 1],
                               cx=intrin[:, 2], cy=intrin[:, 3],
                               distortion=np.zeros((m, 4), np.float32), width=w, height=h),
        points=pts, point_colors=colors, point_errors=np.zeros(len(pts), np.float32),
        track_counts=np.ones(len(pts), np.float32), registered=np.ones(m, bool))
    torch.set_num_threads(2)
    for name, run in (
        ("jax", lambda s: jpipe.train_splat(jscene, images, max_steps=s, downscale_factor=1,
                                            sh_degree=0, seed=args.seed)),
        ("torch", lambda s: tpipe.train_splat(tscene, images, max_steps=s, downscale_factor=1,
                                              sh_degree=0, seed=args.seed, device="cpu")),
    ):
        _, m0 = run(0)
        t0 = time.time()
        cloud, m1 = run(args.steps)
        print(f"{name}: held-out psnr untrained {m0['psnr']:.4f} -> {m1['psnr']:.4f} after "
              f"{args.steps} steps, {cloud.num_points} gaussians ({time.time() - t0:.1f} s)",
              flush=True)


if __name__ == "__main__":
    main()
