"""Readings for the output check's limits, without a measured window.

    python -m splatbench.control --workload <cell> --seeds 1,2,3 --modes program,control,halfbatch

For each seed it makes the cell's scene at the cell's own size and prints
one JSON line per mode with the numbers the check compares:

- program: the program's steps (through Trainer.run, as a run drives them)
  against the reference, the readings the lower end of each limit is set from;
- control: the reference computed with TF32 matrix products put in the
  program's place, which the check has to fail;
- halfbatch: the reference with a planted fault, the loss taken over half
  of the image, in the program's place.

A step that returns its state unchanged reads 1 on `change` by construction
and needs no run. The benchmark's own runs never run this module.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from splatbench import check, harness
from splatbench.manifest import ROOT, load_cell, reference
from splatbench.reference import render as R
from splatbench.scene import make_scene


def as_program(f) -> check.ProgramOut:
    """A reference trajectory in the shape of the program's recorded one."""
    return check.ProgramOut(
        f.losses, [], {**f.first.nu, "cam": f.first.cam_nu},
        {**f.before.params, "cam": f.before.cam}, f.before.grad_accum,
        f.before.count_accum, f.after.params)


def readings(cell, seed: int, modes, device) -> list:
    tr, tc = cell.traffic, cell.config["train"]
    ref_mod = reference(cell.config["reference"])
    scene = make_scene(tr, ref_mod.k_tile(tc, tr["snapshot_step"]), seed, device)
    refines = check.ends_on_refine(tc, tr)

    def follow(**kw):
        return ref_mod.follow(scene.params, scene.images, scene.viewmats, scene.intrinsics,
                         scene.scene_scale, tc, tr["check_step"], tr["check_steps"], seed, **kw)

    outs = {}
    if "program" in modes:
        prog = harness.Program(scene, harness.program_config(cell), seed, device)
        prog.restore(tr["check_step"])
        outs["program"] = check.drive_program(prog.trainer, tr["check_steps"])
        del prog
    if "control" in modes:
        R.precision.tf32 = True
        try:
            outs["control"] = as_program(follow())
        finally:
            R.precision.tf32 = False
    if "halfbatch" in modes:
        outs["halfbatch"] = as_program(follow(half_batch=True))
    t = time.perf_counter()
    ref = follow()
    ref_s = time.perf_counter() - t
    lines = []
    for mode, out in outs.items():
        nums = check.compare(out, ref, scene.params, refines)
        alive0 = int(scene.params["alive"].sum())
        lines.append({"workload": cell.name, "seed": seed, "mode": mode, "numbers": nums,
                      "reference_s": ref_s, "losses": out.losses, "ref_losses": ref.losses,
                      "alive": [alive0, int(ref.after.params["alive"].sum())]})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--modes", default="program,control,halfbatch")
    ap.add_argument("--out", default="", help="also append the lines to this file")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload, ROOT)
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings(cell, seed, args.modes.split(","), device):
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(text + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
