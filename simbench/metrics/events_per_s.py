"""Simulated events of the jobs the window completed, over the window."""


def read(ctx):
    return ctx["events"] / ctx["window_s"] if ctx["events"] else None
