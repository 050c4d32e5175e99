"""The scene generator: sizes and opacities drawn from a trained splat's
rows, taken from pixels at its orbit to world units at the cell's ring."""

import math

import numpy as np
import pytest
import torch

from conftest import CELLS, ROOT
from splatbench import scene
from splatbench.manifest import load_cell


def test_rows_are_taken_from_pixels_to_world_units(tmp_path, monkeypatch):
    row = f"{math.log(2.0)},{math.log(3.0)},{math.log(4.0)},0.5\n"
    (tmp_path / "one.csv").write_text(
        "log_scale_px_0,log_scale_px_1,log_scale_px_2,opacity_logit\n" + row + row)
    monkeypatch.setattr(scene, "SIZES_DIR", str(tmp_path))
    tr = {"capacity": 8, "alive": 5, "sh_degree": 1, "sizes": "one", "ring_radius": 5.0,
          "focal_scale": 0.5, "width": 100, "box_half_widths": [1.0, 1.0, 1.0],
          "quat_noise": 0.1, "sh0_std": 0.5, "shN_std": 0.05}
    gen = torch.Generator().manual_seed(1)
    cloud = scene.draw_cloud(tr, gen, torch.device("cpu"))
    # a pixel at the ring's radius is 5 / 50 = 0.1 world units
    assert torch.allclose(torch.exp(cloud["scales"]),
                          torch.tensor([0.2, 0.3, 0.4]).expand(8, 3), rtol=1e-5)
    assert torch.all(cloud["opacities"] == 0.5) and int(cloud["alive"].sum()) == 5


@pytest.mark.parametrize("cell", CELLS)
def test_the_same_seed_draws_the_same_cloud(cell):
    tr = dict(load_cell(cell, ROOT).traffic, capacity=512, alive=400)
    a, b = (scene.draw_cloud(tr, torch.Generator().manual_seed(2**33 + 5),
                             torch.device("cpu")) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    sizes = scene.size_rows(tr["sizes"])
    assert np.isfinite(sizes).all()
