"""Share of the window in the program's ``lower`` stage: host lowering and
bucket packing."""


def read(ctx):
    return 100.0 * ctx["stats"]["seconds"]["lower"] / ctx["window_s"]
