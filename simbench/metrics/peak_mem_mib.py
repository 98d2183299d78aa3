"""The most device memory allocated at once during the window: the
issued but unforced buckets' operands, draws, plans and outputs."""


def read(ctx):
    return ctx["peak_window_bytes"] / 2**20
