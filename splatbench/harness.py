"""One run of one cell on one process: set-up, the measured window of
segments, the traced extras, and the output check.

Set-up makes the scene from the seed, builds the program's Trainer once,
drives the output check's steps through `Trainer.run`, and runs one warm-up
segment. A segment restores the cell's snapshot (parameters, zero Adam,
densify and camera state, the step, the generator's seed) and calls
`trainer.run(segment_steps)` once; the run ends with its own host read of
the loss. Segments repeat until the window's seconds have passed, and the
last one is finished and counted. With trace, one more segment is timed
without the profiler (refine passes timed one by one), one is profiled for
the device's activity alone, and one for the host's operations as well.

The plain reference is the module of `reference/` that the configuration
file names under `reference`: the output check follows its `follow`, and a
traced run counts the snapshot's work (bytes and operations of the
kernels, of a step) by its `work`. Every metric, end-to-end or per-layer,
is read by `metrics/<name>.py`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from splatbench import check, trace as trace_mod
from splatbench.manifest import Cell, metric_reader, reference
from splatbench.scene import make_scene

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_splat")
VIEWS_PER_STEP = 1  # one process on one card steps one view at a time


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _leaves(tree: dict, prefix: str = "") -> Dict[str, object]:
    """A nested settings block as leaves under dotted names."""
    out: Dict[str, object] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_leaves(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def program_config(cell: Cell):
    """The program's TrainConfig for the model, held leaf by leaf against the
    configuration file's `train`: a stated leaf has the program's value, and
    a leaf the file leaves unstated is at the dataclass default. So a file
    states every setting its model changes from the default."""
    from tpu_splat_torch.gs.trainer import TrainConfig

    model = cell.config["model"]
    cfg = TrainConfig.for_model(model)

    def flat(c):
        return _leaves(json.loads(json.dumps(dataclasses.asdict(c))))

    actual, default, stated = flat(cfg), flat(type(cfg)()), _leaves(cell.config["train"])
    differs = {k: (v, actual[k]) for k, v in stated.items() if k in actual and actual[k] != v}
    missing = sorted(set(stated) - set(actual))
    unstated = {k: v for k, v in actual.items() if k not in stated and v != default.get(k)}
    if differs or missing or unstated:
        raise ValueError(f"TrainConfig.for_model({model!r}) is not the configuration "
                         f"file's: differs {differs} (file, program); missing from the "
                         f"program {missing}; unstated and not the default {unstated}")
    return cfg


class Program:
    """The program's Trainer and the snapshot each segment restores."""

    def __init__(self, scene, cfg, seed: int, device):
        from tpu_splat_torch.gs.trainer import Trainer

        self.snapshot = scene.params
        self.seed = seed
        self.device = device
        self.trainer = Trainer(dict(scene.params), scene.images, scene.viewmats.cpu().numpy(),
                               scene.intrinsics, scene.scene_scale, cfg, seed=seed,
                               device=device)

    def restore(self, step: int) -> None:
        from tpu_splat_torch.gs.optim import adam_init
        from tpu_splat_torch.gs.strategy import densify_state_init

        t = self.trainer
        t.params = {k: v.clone() for k, v in self.snapshot.items()}
        t.adam = adam_init(t.params)
        t.dstate = densify_state_init(t.params["means"].shape[0], self.device)
        n_views = t.cam_deltas.shape[0]
        t.cam_deltas, t._cam_mu, t._cam_nu = (torch.zeros((n_views, 6), device=self.device)
                                              for _ in range(3))
        t.step = step
        t.generator.manual_seed(self.seed)

    def segment(self, step: int, steps: int) -> bool:
        """One segment; True when its parameters stayed finite."""
        self.restore(step)
        self.trainer.run(steps)
        return bool(torch.isfinite(self.trainer.params["means"]).all())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, started: float,
             clock, device: Optional[torch.device] = None) -> dict:
    """Runs the cell once and returns the result line's object. `started` is
    the process's start on `clock`'s timeline."""
    device = device or torch.device("cuda")
    tr, tc = cell.traffic, cell.config["train"]
    ref_mod = reference(cell.config["reference"])
    k_tile = ref_mod.k_tile(tc, tr["snapshot_step"])
    cfg = program_config(cell)
    scene = make_scene(tr, k_tile, seed, device)
    prog = Program(scene, cfg, seed, device)

    # the output check's steps, through the window's own call
    prog.restore(tr["check_step"])
    out = check.drive_program(prog.trainer, tr["check_steps"])
    if len(set(out.views)) != len(out.views):
        raise RuntimeError(f"the check's steps drew a view twice: {out.views}")
    prog.segment(tr["snapshot_step"], tr["segment_steps"])  # warm-up
    _sync(device)

    t0 = time.perf_counter()
    setup_s = clock() - started
    n_seg, failed, ends = 0, 0, []
    while True:
        failed += not prog.segment(tr["snapshot_step"], tr["segment_steps"])
        n_seg += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    _sync(device)
    window = time.perf_counter() - t0
    steps = n_seg * tr["segment_steps"]

    ctx: dict = {"views": steps * VIEWS_PER_STEP, "window_s": window, "setup_s": setup_s}
    if trace:
        refine_s: List[float] = []
        inner = prog.trainer._default_refine
        d = cfg.densify

        def timed_refine():
            s = prog.trainer.step
            if not (d.refine_start <= s < d.refine_stop and s % d.refine_every == 0):
                return inner()
            _sync(device)
            t = time.perf_counter()
            inner()
            _sync(device)
            refine_s.append(time.perf_counter() - t)

        prog.trainer._default_refine = timed_refine
        t = time.perf_counter()
        prog.segment(tr["snapshot_step"], tr["segment_steps"])
        _sync(device)
        ctx["segment_s"] = time.perf_counter() - t
        ctx["alive_after"] = int(prog.trainer.params["alive"].sum())
        ctx["capacity_after"] = int(prog.trainer.params["alive"].shape[0])
        del prog.trainer._default_refine
        ctx["refine_s"] = refine_s
        ctx["segment_steps"] = tr["segment_steps"]
        def seg():
            prog.segment(tr["snapshot_step"], tr["segment_steps"])

        ctx["device"] = trace_mod.profile_device(seg, lambda: _sync(device))
        ctx["trace"] = trace_mod.profile(seg, lambda: _sync(device))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if trace:
        ctx["work"] = ref_mod.work(scene, tc, tr, k_tile)
    ref = ref_mod.follow(scene.params, scene.images, scene.viewmats, scene.intrinsics,
                         scene.scene_scale, tc, tr["check_step"], tr["check_steps"], seed)
    numbers = check.compare(out, ref, scene.params, check.ends_on_refine(tc, tr))
    correct = check.judge(numbers, cell.limits) and failed == 0

    metrics = {}
    for m in cell.metrics:
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": steps,
              "failed": failed * tr["segment_steps"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx["device"].busy_s
        dev["window_s"] = ctx["device"].window_s
        result["breakdown"] = {"device_ops": ctx["device"].breakdown()["device_ops"],
                               "idle_gaps": ctx["trace"].breakdown()["idle_gaps"]}
        result["segment_s"] = {"unprofiled": ctx["segment_s"],
                               "device_profiled": ctx["device"].window_s,
                               "host_profiled": ctx["trace"].window_s}
        result["scene"] = {"visible_share": ctx["work"]["visible_share"],
                           "pairs_per_view": ctx["work"]["pairs"],
                           "step_ops": ctx["work"]["step_ops"],
                           "alive_after_segment": ctx["alive_after"],
                           "capacity_after_segment": ctx["capacity_after"]}
    result["segments_s"] = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    result["check"] = {k: {"value": _finite_or_text(v), "limit": cell.limits.get(k)}
                       for k, v in numbers.items()}
    return result


def _finite_or_text(v: float):
    return v if math.isfinite(v) else str(v)
