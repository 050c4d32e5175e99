"""Shared helpers: the cells at a size the CPU runs in seconds."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ("splatfacto.indoor-densify", "splatfacto.outdoor-3m")


def tiny(cell):
    """The cell with its traffic cut to 3000 of 4096 slots and six 96x64
    views (a box the ring sees whole); every other parameter as committed."""
    tr = dict(cell.traffic)
    tr.update(capacity=4096, alive=3000, views=6, width=96, height=64, segment_steps=2)
    if tr["ring_radius"] < max(tr["box_half_widths"]):
        tr.update(box_half_widths=[2.0, 1.0, 2.0], ring_radius=1.5)
    return cell._replace(traffic=tr)


@pytest.fixture
def cpu_torch():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield torch
    torch.set_num_threads(threads)
