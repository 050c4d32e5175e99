"""The manifest, the files it names, and a cell added as files alone."""

import json
import os
import re
import shutil

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


def test_a_cell_added_as_new_files_is_found(tmp_path):
    """A config, a traffic mix, a limits file and a metric reader added as new
    files, and new entries in BENCHMARK.json, are taken without editing any
    file the benchmark has."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "splatbench"), root / "splatbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "splatbench").rglob("*") if p.is_file()}
    bench = root / "splatbench"
    config = json.loads((bench / "configs" / "splatfacto.json").read_text())
    config["model"] = "splatfacto-big"
    (bench / "configs" / "big.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "indoor-densify.json").read_text())
    traffic["views"] = 48
    (bench / "traffic" / "half-ring.json").write_text(json.dumps(traffic))
    (bench / "limits" / "big.half-ring.json").write_text(json.dumps({"loss": 1e-4}))
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
    assert cell.limits == {"loss": 1e-4}
    assert [x["name"] for x in cell.metrics] == ["views_seen"]
    assert manifest.metric_reader("views_seen", str(bench)).read({}) == 7.0
    for p, data in before.items():
        assert p.read_bytes() == data, p
