"""A whole run at a tiny size on the CPU: the result line's keys, the
command's refusal without a card, and the output check seeing faults
planted under the timed path."""

import json
import os
import subprocess
import sys

import pytest
import torch

import tpu_splat_torch.gs.trainer as trainer_mod
from conftest import CELLS, ROOT, tiny
from splatbench import harness
from splatbench.manifest import load_cell

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 3_000_000_017  # wider than 32 bits, as the driver's seeds are


def run_tiny(cell_name, trace=False):
    cell = tiny(load_cell(cell_name, ROOT, trace=trace))
    return harness.run_cell(cell, SEED, 0.5, trace, 0.0, lambda: 0.0,
                            device=torch.device("cpu"))


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line_keys(cpu_torch, trace):
    res = run_tiny(CELLS[0], trace)
    assert list(res)[:5] == REQUIRED and list(res)[-1] == "check"
    assert ("breakdown" in res) == trace
    assert set(res) - set(REQUIRED) <= {"breakdown", "scene", "segment_s", "segments_s", "check"}
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "train_mfu_pct" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"train_views_per_s", "setup_s"}
    for c in res["check"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res, allow_nan=False)


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without one")
    out = subprocess.run([sys.executable, "-m", "splatbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_refuses_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "splatbench"), tmp_path / "splatbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "-m", "splatbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cpu_torch, cell):
    assert run_tiny(cell)["correct"] is True


def _unchanged_step(monkeypatch):
    inner = trainer_mod.train_step

    def step(params, adam, dstate, *args, **kw):
        out = inner(params, adam, dstate, *args, **kw)
        return (params, adam, dstate) + tuple(
            torch.zeros_like(x) if isinstance(x, torch.Tensor) else x for x in out[3:])

    monkeypatch.setattr(trainer_mod, "train_step", step)


def _half_batch(monkeypatch):
    inner = trainer_mod.image_loss

    def loss(pred, gt, ssim_lambda=0.2):
        h = pred.shape[0] // 2
        return inner(pred[:h], gt[:h], ssim_lambda)

    monkeypatch.setattr(trainer_mod, "image_loss", loss)


# the faults a one-card training cell can have; it has no exchange between
# cards, and no token or answer of its own beyond the state a step returns
FAULTS = {"state-unchanged": _unchanged_step, "half-batch": _half_batch}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(cpu_torch, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    res = run_tiny(cell)
    assert res["correct"] is False
    assert any(not isinstance(c["value"], float) or c["value"] > c["limit"]
               for c in res["check"].values())
