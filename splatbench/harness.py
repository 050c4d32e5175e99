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

The plain reference that the output check follows is the module of
`reference/` that the configuration file names under `reference`; every
metric, end-to-end or per-layer, is read by `metrics/<name>.py`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from splatbench import check, counts, trace as trace_mod
from splatbench.manifest import Cell, metric_reader, reference
from splatbench.reference import render as R
from splatbench.scene import LEAVES, make_scene

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_splat")
VIEWS_PER_STEP = 1  # one process on one card steps one view at a time


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def program_config(cell: Cell):
    """The program's TrainConfig for the model, checked against the
    configuration file's statement of it."""
    from tpu_splat_torch.gs.trainer import TrainConfig

    cfg = TrainConfig.for_model(cell.config["model"])
    actual = json.loads(json.dumps(dataclasses.asdict(cfg)))
    stated = cell.config["train"]
    diff = {k: (stated[k], actual.get(k)) for k in stated if actual.get(k) != stated[k]}
    missing = sorted(set(actual) - set(stated))
    if diff or missing:
        raise ValueError(f"TrainConfig.for_model({cell.config['model']!r}) is not the "
                         f"configuration file's: differs {diff}, unstated {missing}")
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


@torch.no_grad()
def work_counts(scene, tc: dict, tr: dict, k: int) -> dict:
    """The work of the snapshot's step, averaged over all training views, by
    the plain projection, binning and compositing (tile capacity k): pairs
    and bytes of a compositing launch, the step's f32 operations, the
    visible share."""
    p = scene.params
    alive = int(p["alive"].sum())
    tot: Dict[str, float] = {}
    visible = 0.0
    for v in range(scene.images.shape[0]):
        out = R.render(*(p[x] for x in LEAVES), scene.viewmats[v], scene.intrinsics[v],
                       tr["width"], tr["height"], tc["sh_degree"], k,
                       antialiased=tc["antialiased"], alive=p["alive"])
        for key, val in counts.composite_work(out.counts, out.reached, k).items():
            tot[key] = tot.get(key, 0.0) + val
        visible += float((out.radii > 0).sum()) / alive
    n = scene.images.shape[0]
    work = {key: val / n for key, val in tot.items()}
    elements = sum(int(p[x][0].numel()) for x in LEAVES)
    work["step_ops"] = counts.step_ops(alive, elements, tr["width"] * tr["height"],
                                       work["pairs"], tc["sh_degree"])
    work["visible_share"] = visible / n
    return work


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
        ctx["work"] = work_counts(scene, tc, tr, k_tile)
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
