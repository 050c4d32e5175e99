"""composite_bwd_kernel's share of its roofline: the least time a launch
needs (the larger of its bytes over HBM bandwidth and its f32 operations
over the f32 peak, counted on the snapshot by splatbench/counts and
averaged over the training views) over its device time per launch in the
segment profiled for device activity; nothing where the segment launched it never."""

from splatbench import counts


def read(ctx):
    seconds, launches = ctx["device"].kernel("composite_bwd_kernel")
    if not launches:
        return None
    work = ctx["work"]
    least = counts.least_seconds(work["bwd_bytes"], work["bwd_ops"])
    return 100.0 * least / (seconds / launches)
