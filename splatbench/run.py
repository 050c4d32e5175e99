"""Run one benchmark cell once and print its result as the last line.

    python -m splatbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, and with --trace 1 the
breakdown); the numbers the output check compared, each beside its limit,
are the last lines of standard error and the result's last key. The exit
code is not 0, and no result is printed, when CUDA is missing or has fewer
cards than the cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _boot_clock() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def _process_start() -> float:
    """This process's start on the boot clock (/proc/self/stat field 22),
    or now where that cannot be read."""
    now = _boot_clock()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return start if 0.0 <= now - start < 600.0 else now


STARTED = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, "build", "splatbench")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "nv_compute"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(CACHE, sub)

    import torch

    from splatbench import harness
    from splatbench.manifest import launcher, load_cell

    cell = load_cell(args.workload, ROOT, trace=bool(args.trace))
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"splatbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = launcher(cell.config["launcher"]).run(
        cell, args.seed, args.seconds, bool(args.trace), STARTED, _boot_clock)
    found = harness.forbidden_modules()
    if found:
        print(f"splatbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
