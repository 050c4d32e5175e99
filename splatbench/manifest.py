"""The benchmark's manifest and the files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by its name in BENCHMARK.json:

- configs/<config>.json: the model name the program is given, its source,
  `reduced`, `assumed`, the launcher, the reference, and the training
  configuration stated in full (`train`), which the reference reads;
- traffic/<traffic>.json: the parameters the scene generator reads;
- limits/<cell>.json: the limit of each number the output check compares;
- metrics/<metric>.py: a reader with `read(ctx)`, returning the value or
  None where it finds nothing to read, for end-to-end and per-layer metrics;
- launchers/<launcher>.py: `run(cell, seed, seconds, trace, started,
  clock)`, which runs one cell once;
- reference/<reference>.py: the plain reference, with `follow(...)`, the
  steps the output check follows, `k_tile(train, step)`, and
  `work(scene, train, traffic, k)`, the snapshot's work a traced run reads
  the kernels' roofline shares and the step's share of the peak against.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType
from typing import List, NamedTuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    entry: dict       # the workloads entry
    config: dict
    traffic: dict
    limits: dict
    metrics: List[dict]  # BENCHMARK.json metric entries this cell reports


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return load_module(os.path.join(bench_dir, "metrics", f"{name}.py"),
                       f"splatbench_metric_{name.replace('.', '_').replace('-', '_')}")


def launcher(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return load_module(os.path.join(bench_dir, "launchers", f"{name}.py"),
                       f"splatbench_launcher_{name.replace('.', '_').replace('-', '_')}")


def reference(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return importlib.import_module(f"{os.path.basename(bench_dir)}.reference.{name}")


def cell_metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of this cell reports: its end-to-end metrics, or with
    trace its per-layer ones; an entry without `workloads` is every cell's."""
    entries = manifest["per_layer"] if trace else manifest["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: str = ROOT, trace: bool = False) -> Cell:
    manifest = load_manifest(root)
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[0]
    config = _json(os.path.join(bench_dir, "configs", f"{entry['config']}.json"))
    traffic = _json(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json"))
    limits = _json(os.path.join(bench_dir, "limits", f"{name}.json"))
    return Cell(name, entry, config, traffic, limits, cell_metrics(manifest, name, trace))
