"""What the benchmark's modules import, by their sources and in a process."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "splatbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_splat"}


def _modules():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    # top-level names compared whole: tpu_splat_torch is not tpu_splat
    assert not set(_imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in _modules() if "/reference/" in p),
                         ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_program(path):
    assert set(_imported_tops(path)) <= {"__future__", "math", "typing", "numpy", "torch",
                                         "splatbench"}
    tree = ast.parse(open(path).read(), path)
    inside = [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and (n.module or "").startswith("splatbench")]
    assert all(m.startswith("splatbench.reference") for m in inside), inside


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from splatbench import harness

    monkeypatch.setitem(sys.modules, "tpu_splat_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; import splatbench.run, splatbench.harness, splatbench.control; "
            "import tpu_splat_torch.gs.trainer; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tpu_splat'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
