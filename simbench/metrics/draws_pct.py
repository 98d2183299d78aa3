"""Share of the window in the program's ``draws`` stage: operand upload,
draw stream and arrival plan (union of CUDA-event intervals)."""


def read(ctx):
    return 100.0 * ctx["stats"]["seconds"]["draws"] / ctx["window_s"]
