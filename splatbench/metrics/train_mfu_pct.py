"""The training step's share of the card's f32 peak: the f32 operations a
step needs (splatbench/counts.step_ops, on the snapshot, averaged over the
training views) over the unprofiled segment's seconds per step times the
peak."""

from splatbench import counts


def read(ctx):
    per_step = ctx["segment_s"] / ctx["segment_steps"]
    return 100.0 * ctx["work"]["step_ops"] / (per_step * counts.F32_OPS_PER_S)
