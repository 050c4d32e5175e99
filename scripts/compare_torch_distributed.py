"""Record the JAX package's multi-device training outcome that
tests/test_torch_distributed.py holds the port against.

    JAX_PLATFORMS=cpu python scripts/compare_torch_distributed.py --record

runs the reference (make_distributed_train_step on a 2x2 mesh of four XLA CPU
devices, plain and masked, and DistributedTrainer through a refine and an
opacity reset; about 40 s on one core) on the test's seeded scene and writes
tests/torch_distributed_reference.npz. Without --record it prints how far the
reference's fresh outcome is from the record.
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--record", action="store_true", help="rewrite the test's record")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from test_torch_distributed import RECORD, reference_outcome, rel, scene

    torch.set_num_threads(1)
    fresh = reference_outcome(scene())
    if args.record:
        np.savez_compressed(RECORD, **fresh)
        print(f"wrote {os.path.relpath(RECORD, ROOT)}: {len(fresh)} arrays")
        return
    rec = dict(np.load(RECORD))
    for key in sorted(rec):
        same = (np.array_equal(fresh[key], rec[key]) if rec[key].dtype == bool
                else rel(fresh[key], rec[key]))
        print(f"{key}: {same}")


if __name__ == "__main__":
    main()
