"""Share of the window in the program's ``engine_only`` stage: the event
loop (K1) outside every draw interval (union of CUDA-event intervals)."""


def read(ctx):
    return 100.0 * ctx["stats"]["seconds"]["engine_only"] / ctx["window_s"]
