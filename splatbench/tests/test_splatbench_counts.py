"""The yardstick's arithmetic on hand-worked cases, and the trace reduction
on a synthetic timeline."""

import pytest
import torch

from conftest import CELLS, ROOT, tiny
from splatbench import counts, trace


def test_composite_work_two_tiles():
    # K = 256 (2 chunks); tile 0 keeps 200 pairs and its sweep reached both
    # chunks; tile 1 keeps 100 and stopped after its first
    w = counts.composite_work(torch.tensor([200, 100]),
                              torch.tensor([[True, True], [True, False]]), 256)
    assert w["pairs"] == (200 + 100) * 256
    chunk_bytes = 3 * 128 * 10 * 4
    assert w["fwd_bytes"] == chunk_bytes + 2 * 4 + 2 * 8 * 256 * 4 + 2 * 2 * 256 * 4
    assert w["bwd_bytes"] == (chunk_bytes + 2 * 5 * 256 * 4 + 2 * 2 * 256 * 4 + 2 * 256 * 4
                              + 16 * 2 * 256 * 4)
    assert w["fwd_ops"] == 30 * w["pairs"] and w["bwd_ops"] == 66 * w["pairs"]


def test_pairs_are_cut_at_the_chunks_reached():
    # 300 kept pairs, but the sweep stopped after one chunk: 128 real pairs
    w = counts.composite_work(torch.tensor([300]), torch.tensor([[True, False, False]]), 384)
    assert w["pairs"] == 128 * 256


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert counts.least_seconds(3.35e9, 134e12) == pytest.approx(2.0)


def test_step_ops_adds_rows_pixels_and_pairs():
    rows = counts.step_ops(1, 59, 0, 0, 3)
    assert rows == (counts.PROJECTION_OPS + counts.sh_ops(3) + counts.DENSIFY_OPS
                    + 59 * counts.ADAM_OPS_PER_ELEMENT)
    assert counts.step_ops(0, 59, 10, 0, 3) == 10 * counts.PIXEL_OPS
    assert counts.step_ops(0, 59, 0, 2, 3) == 2 * 96
    assert counts.sh_ops(3) == (22 + 50 + 90) + (90 + 50 + 20)


def test_idle_share_is_the_union_of_device_intervals():
    # window 0-100 ns; device ops 10-30 and 20-40 overlap (busy 10-40),
    # 60-70; 95-120 is clipped to 95-100: busy 30 + 10 + 5 = 45 ns
    dev = [trace.Interval(10, 30, "a"), trace.Interval(20, 40, "b"),
           trace.Interval(60, 70, "a"), trace.Interval(95, 120, "c")]
    host = [trace.Interval(0, 100, "run"), trace.Interval(38, 62, "aten::nonzero"),
            trace.Interval(40, 45, "cudaStreamSynchronize")]
    t = trace.reduce((0, 100), dev, host)
    assert t.busy_s == pytest.approx(45e-9) and t.window_s == pytest.approx(100e-9)
    assert t.device_ops["a"] == (pytest.approx(30e-9), 2)
    assert t.kernel("a") == (pytest.approx(30e-9), 2)
    # gaps 0-10 (in "run"), 40-60 (starts in cudaStreamSynchronize), 70-95 ("run")
    assert t.idle_by_host_op == {"run": pytest.approx(35e-9),
                                 "cudaStreamSynchronize": pytest.approx(20e-9)}
    b = t.breakdown()
    assert b["device_ops"][0][0] == "a" and b["idle_gaps"][0] == ["run", pytest.approx(35e-9)]


def test_a_gap_with_no_host_op_is_named_so():
    t = trace.reduce((0, 10), [trace.Interval(0, 5, "k")], [])
    assert t.idle_by_host_op == {"(host between operations)": pytest.approx(5e-9)}


def test_idle_share_reads_the_device_only_trace():
    from splatbench.manifest import metric_reader

    dev = trace.reduce((0, 100), [trace.Interval(10, 30, "a"), trace.Interval(20, 40, "b")],
                       [])
    host = trace.reduce((0, 400), [trace.Interval(10, 30, "a")], [])  # a stretched window
    value = metric_reader("device_idle_pct").read({"device": dev, "trace": host})
    assert value == pytest.approx(70.0)


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_counts_the_snapshots_work(cpu_torch, cell):
    """reference/train.work on the tiny scene: the keys the harness and the
    metric readers read, the pairs' operations at 30 and 66 a pair, and a
    step's operations at least those of its pairs."""
    from splatbench.manifest import load_cell, reference
    from splatbench.scene import make_scene

    c = tiny(load_cell(cell, ROOT))
    tr, tc = c.traffic, c.config["train"]
    ref = reference(c.config["reference"])
    k = ref.k_tile(tc, tr["snapshot_step"])
    work = ref.work(make_scene(tr, k, 3_000_000_017, torch.device("cpu")), tc, tr, k)
    assert set(work) == {"pairs", "fwd_bytes", "bwd_bytes", "fwd_ops", "bwd_ops",
                         "step_ops", "visible_share"}
    assert work["pairs"] > 0 and 0.0 < work["visible_share"] <= 1.0
    assert work["fwd_ops"] == pytest.approx(counts.FWD_OPS_PER_PAIR * work["pairs"])
    assert work["bwd_ops"] == pytest.approx(counts.BWD_OPS_PER_PAIR * work["pairs"])
    assert work["fwd_bytes"] > 0 and work["bwd_bytes"] > work["fwd_bytes"]
    assert work["step_ops"] > work["pairs"] * (counts.FWD_OPS_PER_PAIR
                                               + counts.BWD_OPS_PER_PAIR)
