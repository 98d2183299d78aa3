"""Process start to the first job of the window: CUDA context, the
kernel library (built on a checkout's first run), the warm-up."""


def read(ctx):
    return ctx["setup_s"]
