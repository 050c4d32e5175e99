"""Seconds from the process's start to the first timed segment: imports,
the kernel library, the scene, the output check's steps and the warm-up
segment."""


def read(ctx):
    return ctx["setup_s"]
