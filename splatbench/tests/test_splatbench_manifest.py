"""The manifest, the files it names, and a cell added as files alone."""

import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT
from splatbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    m = manifest.load_manifest(ROOT)
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["splatbench"] and 1 <= m["run_seconds"] <= 51
    e2e = {x["name"] for x in m["end_to_end"]}
    assert {"setup_s", "train_views_per_s"} == e2e
    cells = {w["name"] for w in m["workloads"]}
    assert cells == set(CELLS)
    for entry in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for metric in m["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e and set(metric["workloads"]) <= cells
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    c = manifest.load_cell(cell, ROOT, trace=True)
    assert c.config["model"] == c.entry["config"]
    assert c.traffic["segment_steps"] > 0 and c.limits
    assert {m["name"] for m in c.metrics} >= {"train_mfu_pct", "device_idle_pct"}
    e2e = manifest.load_cell(cell, ROOT, trace=False).metrics
    assert {m["name"] for m in e2e} == {"train_views_per_s", "setup_s"}
    for m in c.metrics + e2e:
        assert callable(manifest.metric_reader(m["name"]).read)
    assert callable(manifest.launcher(c.config["launcher"]).run)
    ref = manifest.reference(c.config["reference"])
    assert callable(ref.follow) and callable(ref.k_tile)
    from splatbench.scene import size_rows

    assert size_rows(c.traffic["sizes"]).shape[0] >= 1000


def test_end_to_end_readers_read_the_window():
    ctx = {"views": 600, "window_s": 20.0, "setup_s": 31.5}
    assert manifest.metric_reader("train_views_per_s").read(ctx) == 30.0
    assert manifest.metric_reader("setup_s").read(ctx) == 31.5


@pytest.mark.parametrize("cell", CELLS)
def test_configuration_file_states_the_program_config(cell):
    from splatbench.harness import program_config

    cfg = program_config(manifest.load_cell(cell, ROOT))
    assert cfg.sh_degree == 3 and cfg.tile_size == 16 and cfg.max_per_tile == 256


def _widened():
    """TrainConfig with one new top-level field and one new leaf in `mcmc`,
    as a model that needs a new setting would widen it."""
    from tpu_splat_torch.gs.mcmc import MCMCConfig
    from tpu_splat_torch.gs.trainer import TrainConfig

    def widen(base, fields):
        return dataclasses.make_dataclass(base.__name__, fields, bases=(base,),
                                          frozen=base.__dataclass_params__.frozen)

    mcmc = widen(MCMCConfig, [("cap_max", int, 1_000_000)])
    return widen(TrainConfig, [("renderer", str, "ewa"),
                               ("mcmc", mcmc, dataclasses.field(default_factory=mcmc))]), mcmc


def _program(wide, mcmc, **change):
    """The widened default, with `renderer` or `mcmc.cap_max` changed."""
    cfg = wide()
    if "cap_max" in change:
        cfg = dataclasses.replace(cfg, mcmc=mcmc(cap_max=change.pop("cap_max")))
    return dataclasses.replace(cfg, **change)


# (program's change, file's change, the part of the refusal and the leaf it
# names; None where the file is taken)
LEAF_CASES = {
    "new-leaves-at-default": ({}, {}, None),
    "top-leaf-unstated": ({"renderer": "3dgut"}, {}, ("unstated", "renderer")),
    "nested-leaf-unstated": ({"cap_max": 4_000_000}, {}, ("unstated", "mcmc.cap_max")),
    "stated-leaf-the-program-lacks": ({}, {"densify.grow_scale2d": 0.05},
                                      ("missing", "densify.grow_scale2d")),
    "stated-nested-leaf-differs": ({}, {"densify.grad_threshold": 0.0001},
                                   ("differs", "densify.grad_threshold")),
}


@pytest.mark.parametrize("case", sorted(LEAF_CASES))
def test_configuration_file_is_held_leaf_by_leaf(monkeypatch, case):
    """A file states every setting its model changes from the default: a
    widened TrainConfig at its defaults is taken, and each offending leaf
    is refused by its dotted name."""
    from splatbench.harness import program_config
    from tpu_splat_torch.gs.trainer import TrainConfig

    program_change, file_change, refusal = LEAF_CASES[case]
    wide, mcmc = _widened()
    cfg = _program(wide, mcmc, **program_change)
    monkeypatch.setattr(TrainConfig, "for_model",
                        classmethod(lambda cls, model, max_steps=30000: cfg))
    cell = manifest.load_cell(CELLS[0], ROOT)
    train = copy.deepcopy(cell.config["train"])
    for dotted, value in file_change.items():
        group, leaf = dotted.split(".")
        train[group][leaf] = value
    cell = cell._replace(config={**cell.config, "train": train})
    if refusal is None:
        assert program_config(cell) is cfg
        return
    with pytest.raises(ValueError) as err:
        program_config(cell)
    part, leaf = refusal
    parts = str(err.value).split(";")
    named = [p for p in parts if f"'{leaf}'" in p]
    assert len(named) == 1 and part in named[0], str(err.value)


# a reference module a new configuration brings: train's steps, its own work
OWN_REFERENCE = """from splatbench.reference.train import follow, k_tile  # noqa: F401

WORK = {"pairs": 5.0, "fwd_bytes": 1.0, "bwd_bytes": 2.0, "fwd_ops": 3.0, "bwd_ops": 4.0,
        "step_ops": 7.0, "visible_share": 0.25}


def work(scene, tc, tr, k):
    return dict(WORK)
"""

# run_tiny's path in a process that imports the benchmark from the checkout
# it is given (the first argument) and the program from the repository
TINY_TRACED_RUN = """import json, os, sys
root = sys.argv[1]
sys.path[:0] = [root, os.path.join(root, "splatbench", "tests")]
sys.path.append(sys.argv[2])
import torch
torch.set_num_threads(2)
from test_splatbench_run import run_tiny
res = run_tiny(sys.argv[3], trace=True)
print(json.dumps({"correct": res["correct"], "scene": res["scene"],
                  "metrics": res["metrics"]}))
"""


def test_a_cell_added_as_new_files_is_found(tmp_path):
    """A config naming a reference of its own, a traffic mix, a limits file
    and a metric reader added as new files, and new entries in
    BENCHMARK.json, are taken without editing any file the benchmark has: a
    tiny traced run reports the new reference's work."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "splatbench"), root / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "splatbench").rglob("*") if p.is_file()}
    bench = root / "splatbench"
    config = json.loads((bench / "configs" / "splatfacto.json").read_text())
    config["model"] = "splatfacto-big"
    config["reference"] = "own_work"
    config["train"]["densify"]["grad_threshold"] = 0.0001
    (bench / "configs" / "big.json").write_text(json.dumps(config))
    (bench / "reference" / "own_work.py").write_text(OWN_REFERENCE)
    traffic = json.loads((bench / "traffic" / "indoor-densify.json").read_text())
    traffic["views"] = 48
    (bench / "traffic" / "half-ring.json").write_text(json.dumps(traffic))
    limits = json.loads((bench / "limits" / "splatfacto.indoor-densify.json").read_text())
    (bench / "limits" / "big.half-ring.json").write_text(json.dumps(limits))
    (bench / "metrics" / "views_seen.py").write_text("def read(ctx):\n    return 7.0\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "big", "source": "https://example.org",
                         "file": "splatbench/configs/big.json", "reduced": [], "why": "x"})
    m["workloads"].append({"name": "big.half-ring", "config": "big",
                           "traffic": "half-ring", "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "views_seen", "unit": "views", "better": "higher",
                           "source": "program_counter", "layer": "Device",
                           "moves": "train_views_per_s", "workloads": ["big.half-ring"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    cell = manifest.load_cell("big.half-ring", str(root), trace=True)
    assert cell.config["model"] == "splatfacto-big" and cell.traffic["views"] == 48
    assert cell.limits == limits
    assert [x["name"] for x in cell.metrics] == ["views_seen"]
    assert manifest.metric_reader("views_seen", str(bench)).read({}) == 7.0

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", TINY_TRACED_RUN, str(root), ROOT,
                          "big.half-ring"], cwd=root, capture_output=True, text=True,
                         timeout=300, env={**env, "PYTHONDONTWRITEBYTECODE": "1"})
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert {k: res["scene"][k] for k in ("visible_share", "pairs_per_view", "step_ops")} == {
        "visible_share": 0.25, "pairs_per_view": 5.0, "step_ops": 7.0}
    assert res["metrics"]["views_seen"]["value"] == 7.0
    for p, data in before.items():
        assert p.read_bytes() == data, p
