"""Training views stepped in the window's segments over the window's time,
from the first segment's start to the last one's synchronised end."""


def read(ctx):
    return ctx["views"] / ctx["window_s"]
