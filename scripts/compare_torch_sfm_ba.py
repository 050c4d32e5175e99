"""How far the port's bundle_adjust lands from the JAX package's, beside how far
the JAX package's own result moves under a last-bit change of its input, on
the seeded synthetic problems of tests/test_torch_sfm_ba.py, on the CPU.

    JAX_PLATFORMS=cpu python scripts/compare_torch_sfm_ba.py --seeds 0-9

For each seed and for pinhole and focal+k1 refinement (the test's settings:
8 outer rounds of 24 CG steps), it prints the largest relative difference
over R, t, X, rms (and focal, k1) of:
  port-ref   the port against the reference on the same f32 input;
  ref-ulp    the reference against itself with every f32 input (poses,
             points, observations) moved one unit in the last place;
  ref-f64    the reference in f32 against the reference in f64 (jax x64);
  port-ulp   the port against itself under the same last-bit change;
  port-f64   the port in f32 against the reference in f64.
If port-ref is of the size of ref-ulp, and port-f64 of the size of ref-f64,
the two packages differ by the problem's conditioning in f32, not by their
steps.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-9", help="a range a-b or a comma list")
    args = ap.parse_args()
    seeds = (range(int(args.seeds.split("-")[0]), int(args.seeds.split("-")[1]) + 1)
             if "-" in args.seeds else [int(s) for s in args.seeds.split(",")])

    import jax
    import jax.numpy as jnp
    import torch

    from test_torch_sfm_ba import as_jax, as_torch, synthetic_problem
    from tpu_splat.sfm import ba as jba
    from tpu_splat_torch.sfm import ba as tba

    torch.set_num_threads(1)
    names = ("R", "t", "X", "rms", "focal", "k1")

    def rel(a, b):
        out = {}
        for n, x, y in zip(names, a, b):
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            out[n] = float(np.max(np.abs(x - y)) / (np.max(np.abs(x)) + 1e-12))
        return out

    def ulp(arrs):
        return [np.nextafter(a, np.float32(np.inf)) if a.dtype == np.float32 else a
                for a in arrs]

    def ref64(arrs, kw):
        jax.config.update("jax_enable_x64", True)
        try:
            prob = jba.BAProblem(*[jnp.asarray(a.astype(np.float64) if a.dtype == np.float32
                                               else a) for a in arrs])
            return [np.asarray(x) for x in jba.bundle_adjust(prob, **kw)]
        finally:
            jax.config.update("jax_enable_x64", False)

    print(f"{'seed':>4} {'mode':>8} {'port-ref':>10} {'ref-ulp':>10} {'ref-f64':>10} "
          f"{'port-ulp':>10} {'port-f64':>10}  worst field (port-ref)")
    for seed in seeds:
        for calib in (False, True):
            arrs = synthetic_problem(seed, focal_scale=1.03 if calib else 1.0,
                                     k1=-0.05 if calib else 0.0)
            kw = dict(huber_delta=2.0 / 300, outer_iters=8, cg_iters=24,
                      optimize_focal=calib, optimize_k1=calib)
            ref = [np.asarray(x) for x in jba.bundle_adjust(as_jax(arrs), **kw)]
            got = [x.numpy() for x in tba.bundle_adjust(as_torch(arrs), **kw)]
            ref_u = [np.asarray(x) for x in jba.bundle_adjust(as_jax(ulp(arrs)), **kw)]
            got_u = [x.numpy() for x in tba.bundle_adjust(as_torch(ulp(arrs)), **kw)]
            r64 = ref64(arrs, kw)
            d = {k: max(rel(ref, b).values()) for k, b in
                 (("port-ref", got), ("ref-ulp", ref_u), ("ref-f64", r64))}
            d["port-ulp"] = max(rel(got, got_u).values())
            d["port-f64"] = max(rel(r64, got).values())
            pr = rel(ref, got)
            worst = max(pr, key=pr.get)
            print(f"{seed:>4} {'focal+k1' if calib else 'pinhole':>8} {d['port-ref']:10.2e} "
                  f"{d['ref-ulp']:10.2e} {d['ref-f64']:10.2e} {d['port-ulp']:10.2e} "
                  f"{d['port-f64']:10.2e}  {worst}",
                  flush=True)


if __name__ == "__main__":
    main()
