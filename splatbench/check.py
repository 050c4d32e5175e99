"""The output check: what the program's first steps produced, against the
plain reference following the same steps from the same snapshot.

The window's own call drives those steps: set-up restores the snapshot at
the traffic's `check_step` and calls `Trainer.run(check_steps)` once, which
draws its views (all different) as every run does and ends its chunk with the
host's refine work where the schedule has it. A recorder wrapped on the
instance keeps each step's loss, the Adam state after the first step and the
parameters and densify accumulators after the last; it is taken off before
the window. Each number is a gap between the program's reading and the
reference's:

- loss: the largest relative gap of a step's loss;
- grad: the first gradient's norm as the optimizer got it, worked out from
  its second moment after one step (sqrt(nu / (1 - b2)), the state being
  zero before it), by the worst leaf;
- change: the norm of each leaf's change over the steps, by the worst leaf,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's;
- densify: the accumulated screen-gradient norm and visible count;
- refine_slots, refine_change (where the steps end on a refine pass): the
  slots whose liveness differs, over the slots the reference's pass changed;
  and the norm of each leaf over the rows the pass wrote, by the worst leaf.
  Both read a flipped request as one row, whichever dead slots the later
  requests then took.

A leaf's gap is |program norm - reference norm| over the larger of the
reference's norm of that leaf and of the median leaf.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, NamedTuple

import torch

from splatbench.reference.train import B2, LEAVES, Followed

ALL = LEAVES + ("cam",)


class ProgramOut(NamedTuple):
    losses: List[float]
    views: List[int]
    nu1: Dict[str, torch.Tensor]      # Adam second moments after step 1, "cam" included
    before: Dict[str, torch.Tensor]   # parameters after the last step, "cam" and "alive" included
    grad_accum: torch.Tensor
    count_accum: torch.Tensor
    after: Dict[str, torch.Tensor]    # parameters once the chunk ended


def drive_program(trainer, steps: int) -> ProgramOut:
    """trainer.run(steps) from the state it holds, recording as it goes."""
    losses, views, rec = [], [], {}
    inner = trainer._train_one

    def recorder(view, step_cfg, sh_degree):
        metrics = inner(view, step_cfg, sh_degree)
        losses.append(metrics["loss"].detach().clone())
        views.append(int(view))
        if len(losses) == 1:
            rec["nu1"] = {k: v.clone() for k, v in trainer.adam.nu.items()}
            rec["nu1"]["cam"] = trainer._cam_nu.clone()
        if len(losses) == steps:
            rec["before"] = {k: v.clone() for k, v in trainer.params.items()}
            rec["before"]["cam"] = trainer.cam_deltas.clone()
            rec["dstate"] = (trainer.dstate.grad_accum.clone(),
                             trainer.dstate.count_accum.clone())
        return metrics

    trainer._train_one = recorder
    try:
        trainer.run(steps)
    finally:
        del trainer._train_one
    after = {k: v.clone() for k, v in trainer.params.items()}
    return ProgramOut([float(x) for x in losses], views, rec["nu1"], rec["before"],
                      rec["dstate"][0], rec["dstate"][1], after)


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.norm(x.double().reshape(-1)))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """Where every reference norm is 0 (a pass that wrote no row), any
    program norm but 0 is an infinite gap."""
    med = statistics.median(ref.values())

    def gap(p: float, r: float) -> float:
        scale = max(r, med)
        return abs(p - r) / scale if scale > 0 else (0.0 if p == r else math.inf)

    gaps = [gap(prog[k], ref[k]) for k in ref if keep is None or k in keep]
    return max(gaps) if gaps else 0.0


def grad_norms(nu: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: math.sqrt(float(nu[k].double().sum()) / (1.0 - B2)) for k in ALL}


def ends_on_refine(tc: dict, tr: dict) -> bool:
    """Whether the check's steps end where the schedule has a refine pass."""
    end, d = tr["check_step"] + tr["check_steps"], tc["densify"]
    return d["refine_start"] <= end < d["refine_stop"] and end % d["refine_every"] == 0


def compare(prog: ProgramOut, ref: Followed, start: Dict[str, torch.Tensor],
            refines: bool) -> Dict[str, float]:
    out = {"loss": max(abs(lp - lr) / abs(lr) for lp, lr in zip(prog.losses, ref.losses))}
    g_ref = grad_norms({**ref.first.nu, "cam": ref.first.cam_nu})
    out["grad"] = leaf_gap(grad_norms(prog.nu1), g_ref)
    med = statistics.median(g_ref.values())
    moving = {k for k, v in g_ref.items() if v >= 1e-3 * med}

    def change(params, cam):
        c = {k: _norm(params[k] - start[k]) for k in LEAVES}
        c["cam"] = _norm(cam)
        return c

    out["change"] = leaf_gap(change(prog.before, prog.before["cam"]),
                             change(ref.before.params, ref.before.cam), moving)
    ga_r = _norm(ref.before.grad_accum)
    cnt_r = float(ref.before.count_accum.double().sum())
    out["densify"] = max(abs(_norm(prog.grad_accum) - ga_r) / ga_r,
                         abs(float(prog.count_accum.double().sum()) - cnt_r) / cnt_r)
    if refines:
        out.update(compare_refine(prog, ref))
    return out


def compare_refine(prog: ProgramOut, ref: Followed) -> Dict[str, float]:
    pa, ra = prog.after, ref.after.params
    if pa["alive"].shape != ra["alive"].shape:
        return {"refine_slots": math.inf, "refine_change": math.inf}

    def grown(x, n):  # a pass that grew capacity: the old state, padded
        return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])

    def written(after, before):
        """Rows the pass wrote: live after it, and dead before it or with
        new scales (split parents, refilled slots). A set, and its values a
        multiset, that do not depend on which dead slot took which row."""
        was = grown(before["alive"], n)
        rescaled = (after["scales"] != grown(before["scales"], n)).any(dim=-1)
        return after["alive"] & (~was | rescaled)

    n = ra["alive"].shape[0]
    changed_r = int((ra["alive"] ^ grown(ref.before.params["alive"], n)).sum())
    slots = int((pa["alive"] ^ ra["alive"]).sum()) / max(changed_r, 1)
    wp, wr = written(pa, prog.before), written(ra, ref.before.params)
    return {"refine_slots": slots,
            "refine_change": leaf_gap({k: _norm(pa[k][wp]) for k in LEAVES},
                                      {k: _norm(ra[k][wr]) for k in LEAVES})}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number is finite and within its limit, and every limit is read."""
    return (set(numbers) == set(limits)
            and all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items()))
