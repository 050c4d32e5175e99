"""The share of a segment's wall time in which no operation ran on the
device: the union of the device's operation intervals (not their sum) in a
segment profiled for device activity alone, over that segment's host-clock
time. The host's operations are not recorded there, so the profiler leaves
the host's pace, and with it the idle share, nearly as it is unprofiled."""


def read(ctx):
    tr = ctx["device"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
