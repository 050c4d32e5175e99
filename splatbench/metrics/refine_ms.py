"""Mean host-clock milliseconds of a refine pass (`Trainer._default_refine`
on a refine step, synchronised on both sides) in the traced run's
unprofiled segment; nothing where the segment has no refine pass."""


def read(ctx):
    times = ctx["refine_s"]
    return 1e3 * sum(times) / len(times) if times else None
