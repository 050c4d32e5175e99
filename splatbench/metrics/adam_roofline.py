"""adam_step_kernel's share of its roofline: the least time a launch needs
(its least bytes over HBM bandwidth) over its device time per launch in the
segment profiled for device activity; nothing where the segment launched it
never.

The least bytes come from the leaves the kernel was last launched on (the
snapshot's capacity and leaf shapes, as the program's optim.LAST_LAUNCH
records them): per element, the parameter, gradient and both moments read
and the parameter and both moments written (28 bytes, 24 where the first
moment is bf16), and one byte a row for each row mask it read."""

from splatbench import counts


def read(ctx):
    seconds, launches = ctx["device"].kernel("adam_step_kernel")
    if not launches:
        return None
    from tpu_splat_torch.gs import optim

    layout = optim.LAST_LAUNCH
    nbytes = sum(n * (5 * 4 + 2 * mu_bytes) for n, mu_bytes in layout["leaves"])
    nbytes += layout["rows"] * (layout["grad_mask"] + layout["visible"])
    return 100.0 * counts.least_seconds(nbytes, 0.0) / (seconds / launches)
