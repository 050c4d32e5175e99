"""The control on the card: the reference computed with TF32 matrix
products, put in the program's place, fails the check, and the program
passes it, at a reduced size of each cell (the full-size readings are in
PERF.md). Needs a card; skips without one."""

import pytest

from conftest import CELLS, ROOT
from splatbench import check, control
from splatbench.manifest import load_cell


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cuda_device, cell):
    c = load_cell(cell, ROOT)
    tr = dict(c.traffic)
    tr.update(capacity=c.traffic["capacity"] // 8, alive=c.traffic["alive"] // 8,
              views=8, width=c.traffic["width"] // 2, height=c.traffic["height"] // 2)
    c = c._replace(traffic=tr)
    lines = {l["mode"]: l for l in control.readings(c, 11, ["program", "control"],
                                                    cuda_device)}
    assert check.judge(lines["program"]["numbers"], c.limits)
    assert not check.judge(lines["control"]["numbers"], c.limits)


def test_a_leaf_gap_over_a_pass_that_wrote_nothing():
    zero = {"means": 0.0, "scales": 0.0, "opacities": 0.0}
    assert check.leaf_gap(zero, zero) == 0.0
    assert check.leaf_gap({**zero, "means": 1e-9}, zero) == float("inf")
    assert check.leaf_gap({"a": 1.0, "b": 2.2}, {"a": 1.0, "b": 2.0}) == pytest.approx(0.1)
